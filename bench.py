#!/usr/bin/env python
"""Benchmark harness: streaming mapping throughput + DTW cell-updates/s.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "details": {...}}

The baseline is this repo's own native CPU engine (exact-semantics C++
event detection + k-d tree radius search + chaining DP — the same
algorithmic profile as 4-thread CPU Sigmap), run on the same synthetic
workload with a thread pool.  Device timings end in block_until_ready (or
in the host fetches the mapper itself makes).  The run needs a GPU;
--smoke runs on whatever backend JAX has, at toy size.  Every result
names the device it ran on.

Usage: python bench.py [--smoke] [--genome-mb F] [--reads N] [--batch B]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


SWEEP_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".sweep_cache")


def device_info():
    """The device every number here was measured on: JAX's view plus the
    card's name and power limit from nvidia-smi (a child process that
    stays off JAX)."""
    import jax

    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def build_workload(genome_mb: float, n_reads: int, read_bases: int, seed=1,
                   threads=4):
    import dataclasses

    from sigmap_tpu.config import SigmapConfig
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import ReferenceSequence
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu.synth import random_genome, simulate_reads

    cfg = SigmapConfig()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(
            cfg.runtime, sweep_cache_dir=SWEEP_CACHE, num_threads=threads,
        )
    )
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(int(genome_mb * 1e6), seed=seed)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    t0 = time.perf_counter()
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    t_index = time.perf_counter() - t0
    log(f"index: {idx.n_points} points in {t_index:.1f}s")
    reads = simulate_reads(pore, genome, n_reads, seed=seed + 1,
                           read_bases=read_bases)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return cfg, idx, reads, signals, t_index


def accuracy(records, reads):
    by_name = {rec.read_name: rec for rec in records}
    mapped = correct = 0
    for r in reads:
        rec = by_name.get(r.read_id)
        if rec is None or not rec.is_mapped:
            continue
        mapped += 1
        lo, hi = rec.fragment_start, rec.fragment_start + rec.fragment_length
        if rec.direction == r.strand and lo < r.ref_end and hi > r.ref_start:
            correct += 1
    return mapped, correct


def bench_device(cfg, idx, signals, batch, engine="turbo"):
    import dataclasses

    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=batch)
    )
    upload_s = 0.0
    if engine == "turbo":
        from sigmap_tpu.mapping.turbo import TurboMapper

        t0 = time.perf_counter()
        mapper = TurboMapper(idx, cfg)
        # the sweep-store build + upload, timed apart from compiles
        mapper.tiles.block_until_ready()
        upload_s = time.perf_counter() - t0
        log(f"device[turbo]: init + index upload {upload_s:.1f}s")
        run = mapper.streaming_map
    else:
        from sigmap_tpu.mapping.driver import Mapper

        mapper = Mapper(idx, cfg)
        run = mapper.streaming_map
    log(f"device[{engine}]: warmup (compile)...")
    t0 = time.perf_counter()
    run(signals[: min(batch, len(signals))])
    warmup_s = time.perf_counter() - t0
    log(f"device[{engine}]: warmup {warmup_s:.1f}s "
        f"(+ upload {upload_s:.1f}s)")
    trace_dir = getattr(bench_device, "_trace_dir", None)
    if trace_dir:
        # device+host timeline of the timed run (jax.profiler; the
        # reference's analogue is its GetRealTime stderr phase logging,
        # sigmap.cc:536,869 — see SURVEY.md §5)
        import jax

        try:
            jax.profiler.start_trace(trace_dir)
        except Exception as e:  # noqa: BLE001 - backend without profiling
            log(f"jax.profiler unavailable: {e}")
            trace_dir = None
    t0 = time.perf_counter()
    records = run(signals)
    dt = time.perf_counter() - t0
    if trace_dir:
        import jax

        try:
            jax.profiler.stop_trace()
            log(f"jax.profiler trace written to {trace_dir}")
        except Exception as e:  # noqa: BLE001
            log(f"jax.profiler stop failed: {e}")
    return records, len(signals) / dt, dt, warmup_s, upload_s


def bench_cpu_baseline(cfg, idx, signals, threads=4, cap_reads=64, reps=3):
    """Native CPU engine (exact semantics) with a thread pool.

    Pinned protocol: a FIXED read subset, `reps` repetitions, median
    reads/s reported with min/max spread — the per-round `vs_baseline`
    headline previously swung ~2x on single 32-read runs."""
    from sigmap_tpu.oracle import Oracle

    oracle = Oracle(idx, cfg)
    subset = signals[:cap_reads]
    # warm the native lib
    oracle.streaming_read(subset[0].pa)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(lambda s: oracle.streaming_read(s.pa), subset))
        dt = time.perf_counter() - t0
        rates.append(len(subset) / dt)
    rates.sort()
    med = rates[len(rates) // 2]
    return med, (rates[0], rates[-1]), len(subset)


def bench_dtw(B=1024, T=2048, Q=512, reps=10):
    """sDTW cell updates per second of ops/sdtw.sdtw_batch, device-resident
    inputs, timed to block_until_ready."""
    import jax.numpy as jnp

    from sigmap_tpu.ops.sdtw import sdtw_batch

    rng = np.random.default_rng(0)
    ts = jnp.asarray(rng.normal(0, 1, (B, T)).astype(np.float32))
    qs = jnp.asarray(rng.normal(0, 1, (B, Q)).astype(np.float32))
    tl = jnp.full(B, T, jnp.int32)
    ql = jnp.full(B, Q, jnp.int32)
    sdtw_batch(ts, tl, qs, ql)[0].block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = sdtw_batch(ts, tl, qs, ql)
    out[0].block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    return B * T * Q / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--genome-mb", type=float, default=None)
    ap.add_argument("--reads", type=int, default=None)
    ap.add_argument("--read-bases", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--baseline-threads", type=int, default=4)
    ap.add_argument("--engine", choices=["turbo", "exact"],
                    default="turbo",
                    help="device path: turbo (device-resident sweep+fused "
                         "chain) or exact (host chaining oracle)")
    ap.add_argument("--threads", type=int, default=4,
                    help="host threads (quantize/rescue pools), like -t")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a jax.profiler trace of the timed mapping "
                         "run to this directory (view with tensorboard / "
                         "xprof)")
    args = ap.parse_args()
    from sigmap_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    dev = device_info()
    log(f"device: {dev}")
    if dev["platform"] != "gpu" and not args.smoke:
        sys.exit(f"bench.py needs a GPU (JAX found {dev['platform']}); "
                 "use --smoke for a toy-size run elsewhere")
    if args.smoke:
        genome_mb = args.genome_mb or 0.5
        n_reads = args.reads or 16
        batch = args.batch or 16
    else:
        # canonical scale: the reference quickstart is yeast ~12 Mb
        # (/root/reference/README.md:17-23); >= 3 batches so the prefetch
        # pipeline (quantize+upload+events of batch N+1 overlapping batch
        # N's rounds) reaches steady state
        genome_mb = args.genome_mb or 12.0
        n_reads = args.reads or 6144
        batch = args.batch or 2048

    cfg, idx, reads, signals, t_index = build_workload(
        genome_mb, n_reads, args.read_bases, threads=args.threads
    )

    bench_device._trace_dir = args.trace
    records, dev_rps, dev_dt, warmup_s, upload_s = bench_device(
        cfg, idx, signals, batch, engine=args.engine
    )
    mapped, correct = accuracy(records, reads)
    log(f"device: {dev_rps:.2f} reads/s ({dev_dt:.1f}s), "
        f"mapped {mapped}/{len(reads)}, correct {correct}/{max(1,mapped)}")
    # recall gate: every simulated read is mappable and the exact engine
    # maps ~100%; a throughput "win" that unmaps reads must be flagged
    recall_ok = mapped >= 0.99 * len(reads)
    if not recall_ok:
        log(f"RECALL WARNING: only {mapped}/{len(reads)} mapped "
            "(exact engine maps ~100% of simulated reads)")

    cpu_rps, cpu_spread, cpu_reads = bench_cpu_baseline(
        cfg, idx, signals, threads=args.baseline_threads,
        cap_reads=min(64, n_reads),
    )
    log(f"cpu baseline ({args.baseline_threads} threads, {cpu_reads} reads "
        f"x3 reps): median {cpu_rps:.2f} reads/s "
        f"(spread {cpu_spread[0]:.2f}-{cpu_spread[1]:.2f})")

    try:
        dtw_cups = bench_dtw()
        log(f"dtw: {dtw_cups/1e6:.1f}M cell-updates/s (sdtw_batch)")
    except Exception as e:  # noqa: BLE001 - report, keep the mapping result
        log(f"dtw bench failed: {e}")
        dtw_cups = None

    print(json.dumps({
        "metric": "reads_per_s_streaming",
        "value": round(dev_rps, 3),
        "unit": "reads/s",
        "vs_baseline": round(dev_rps / cpu_rps, 3) if cpu_rps else None,
        "device": dev,
        "details": {
            "genome_mb": genome_mb,
            "n_reads": n_reads,
            "read_batch": batch,
            "mapped": mapped,
            "correct": correct,
            "cpu_baseline_reads_per_s_median": round(cpu_rps, 3),
            "cpu_baseline_spread": [round(cpu_spread[0], 3),
                                    round(cpu_spread[1], 3)],
            "cpu_baseline_reads": cpu_reads,
            "cpu_baseline_reps": 3,
            "baseline_threads": args.baseline_threads,
            "dtw_cell_updates_per_s": dtw_cups,
            "index_build_s": round(t_index, 1),
            "engine": args.engine,
            "warmup_s": round(warmup_s, 1),
            "index_upload_s": round(upload_s, 1),
            "recall_ok": recall_ok,
            "host_threads": args.threads,
        },
    }))


if __name__ == "__main__":
    main()
