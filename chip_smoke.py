#!/usr/bin/env python
"""Smoke run of the streaming mapper on one GPU, through its entry points.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded path only

One process drives the card(s); nvidia-smi and the native build run as
children that stay off JAX.  Phases (any failure exits non-zero):

1. device: JAX must see a GPU (no CPU fallback); prints its kind, the JAX
   version, the compile-cache directory and the card's name/power limit.
2. native: builds native/core.cc from the checkout and loads it (the
   rescue pass and the k-d oracle need it; no numpy fallback here).
3. kernels: the sweep and chaining Triton kernels against their plain
   versions at the widths of a 12 Mb synthetic genome (~23.7 M windows),
   B = 2048 reads, S = 256, K = 8, RING = 768, chunk 4000; the sweep also
   against the native k-d tree, chaining against its numpy twin.  Times
   both (warm, block_until_ready) per layer, times turbo_round end to
   end (--swaps: also with each kernel swapped for plain, and all plain),
   and prints memory_analysis() of turbo_round and batch_features.
4. end to end: TurboMapper.streaming_map over 4096 simulated 3000-base
   reads (two batches, so the prefetch overlap runs), gated at >= 99%
   mapped and >= 99% of mapped correct; the exact engine on 256 of them
   (loci agree on >= 98% of reads both map); then the CLI, -i and -m, on
   a BLOW5 directory of 512 reads, checking the PAF it writes.

--four runs TurboShardMapper on meshes data=1 x index=4 and data=2 x
index=2 and compares its records with TurboMapper on device 0 over the
same 2048 reads (exact-engine rescue off on all three, so every record
comes from the device path).  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
GENOME_MB = 12.0
READ_BASES = 3000
BATCH = 2048


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()


def workload(n_reads, threads, sweep_cache_dir=None):
    from sigmap_tpu.config import SigmapConfig
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import ReferenceSequence
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu.synth import random_genome, simulate_reads

    cfg = SigmapConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, read_batch=BATCH, num_threads=threads,
        sweep_cache_dir=sweep_cache_dir))
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(int(GENOME_MB * 1e6), seed=1)
    idx = build_index([ReferenceSequence(n, c) for n, c in genome], pore,
                      cfg.index, cfg.mapping.search_radius, verbose=False)
    reads = simulate_reads(pore, genome, n_reads, seed=2,
                           read_bases=READ_BASES)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    log(f"workload: {GENOME_MB} Mb genome, {idx.n_windows} windows, "
        f"{n_reads} reads of {READ_BASES} bases")
    return cfg, pore, genome, idx, reads, signals


def accuracy(records, reads):
    by_name = {r.read_name: r for r in records}
    mapped = correct = 0
    for r in reads:
        rec = by_name.get(r.read_id)
        if rec is None or not rec.is_mapped:
            continue
        mapped += 1
        lo, hi = rec.fragment_start, rec.fragment_start + rec.fragment_length
        correct += (rec.direction == r.strand and lo < r.ref_end
                    and hi > r.ref_start)
    return mapped, correct


def loci_agree(a, b, slack=500):
    ta = {r.read_name: r for r in a}
    both = agree = 0
    for r in b:
        t = ta.get(r.read_name)
        if t is None or not (t.is_mapped and r.is_mapped):
            continue
        both += 1
        agree += (
            t.ref_index == r.ref_index and t.direction == r.direction
            and t.fragment_start < r.fragment_start + r.fragment_length + slack
            and t.fragment_start + t.fragment_length > r.fragment_start - slack
        )
    return both, agree


def paf_lines(records, idx):
    from sigmap_tpu.io.paf import mapped_line, unmapped_line

    out = []
    for r in sorted(records, key=lambda x: x.read_id):
        line = (mapped_line(r, idx.ref_names[r.ref_index],
                            idx.ref_lengths[r.ref_index])
                if r.is_mapped else unmapped_line(r))
        # mt:f is wall-clock and differs between runs
        out.append("\t".join(f for f in line.split("\t")
                             if not f.startswith("mt:")))
    return out


def run_one_card(summary, swaps):
    import jax

    from sigmap_tpu import kernel_checks as kc
    from sigmap_tpu import native
    from sigmap_tpu.mapping.turbo import TurboMapper

    with phase("native library"):
        t0 = time.perf_counter()
        native.require()
        log(f"native: {native._SO} ({time.perf_counter() - t0:.1f} s)")

    with phase("workload"):
        cfg, pore, genome, idx, reads, signals = workload(2 * BATCH, 8)
        t0 = time.perf_counter()
        tm = TurboMapper(idx, cfg)
        tm.tiles.block_until_ready()
        summary["index_upload_s"] = time.perf_counter() - t0
        log(f"TurboMapper: {tm.p}; sweep store {tm.tiles.shape} "
            f"({summary['index_upload_s']:.1f} s)")

    with phase("kernels at real widths"):
        checks = kc.run_all(tm, signals[:BATCH], log=log)
        ends, mem, shape = kc.round_variants(
            tm, signals[:BATCH], swaps=swaps, log=log)
        for name, m in mem.items():
            log(f"memory_analysis {name} {shape}: {m}")
        summary["layers"] = checks
        summary["end_to_end"] = ends
        summary["memory_analysis"] = {k: str(v) for k, v in mem.items()}

    with phase("end to end: turbo streaming_map"):
        tm.streaming_map(signals[:64])          # compile the small shapes
        t0 = time.perf_counter()
        records = tm.streaming_map(signals)
        dt = time.perf_counter() - t0
        mapped, correct = accuracy(records, reads)
        summary["smoke_reads_per_s"] = len(signals) / dt
        log(f"turbo: {len(signals)} reads in {dt:.2f} s "
            f"({len(signals) / dt:.1f} reads/s, smoke figure), mapped "
            f"{mapped}, correct {correct}")
        need(len(records) == len(signals), "turbo lost records")
        need(mapped >= 0.99 * len(reads),
             f"turbo mapped {mapped}/{len(reads)} < 99%")
        need(correct >= 0.99 * mapped,
             f"turbo correct {correct}/{mapped} < 99% of mapped")

    with phase("end to end: exact engine"):
        from sigmap_tpu.mapping.driver import Mapper

        sub = signals[:256]
        ecfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, read_batch=len(sub)))
        t0 = time.perf_counter()
        exact = Mapper(idx, ecfg).streaming_map(sub)
        dt = time.perf_counter() - t0
        # each engine reports the chunk range it had mapped when it
        # stopped, and the two may stop at different chunks (ci); two
        # placements of the same read lie within the read's own span
        both, agree = loci_agree(records, exact, slack=READ_BASES)
        _, agree500 = loci_agree(records, exact, slack=500)
        sub_reads = reads[: len(sub)]
        log(f"exact: {len(sub)} reads in {dt:.1f} s; loci agree on "
            f"{agree}/{both} reads both engines map ({agree500} within "
            f"500 bp); vs truth: exact {accuracy(exact, sub_reads)}, turbo "
            f"{accuracy(records, sub_reads)} (mapped, correct)")
        truth = {r.read_id: r for r in sub_reads}
        for e in exact:
            t = [r for r in records if r.read_name == e.read_name][0]
            if loci_agree([t], [e], slack=READ_BASES) == (1, 0):
                log(f"  disagree {e.read_name}: exact "
                    f"{accuracy([e], [truth[e.read_name]])[1]} correct, "
                    f"turbo {accuracy([t], [truth[e.read_name]])[1]} correct")
        summary["exact_loci_agree"] = [agree, both]
        need(both >= 0.95 * len(sub), f"only {both} reads mapped by both")
        need(agree >= 0.98 * both, f"loci agree {agree}/{both} < 98%")

    with phase("end to end: CLI -i / -m on BLOW5"):
        from sigmap_tpu import cli
        from sigmap_tpu.io.slow5 import write_blow5
        from sigmap_tpu.synth import genome_to_fasta_str

        sub = reads[:512]
        with tempfile.TemporaryDirectory() as d:
            ref = os.path.join(d, "ref.fa")
            with open(ref, "w") as f:
                f.write(genome_to_fasta_str(genome))
            model = os.path.join(d, "pore.model")
            pore.save(model)
            sig = os.path.join(d, "sig")
            os.mkdir(sig)
            write_blow5(os.path.join(sig, "reads.blow5"),
                        [r.__dict__ for r in sub])
            prefix = os.path.join(d, "idx")
            need(cli.main(["-i", "-r", ref, "-p", model, "-o", prefix]) == 0,
                 "cli -i failed")
            paf = os.path.join(d, "out.paf")
            need(cli.main(["-m", "-r", ref, "-p", model, "-x", prefix,
                           "-s", sig, "-o", paf, "-t", "8",
                           "--read-batch", str(BATCH)]) == 0,
                 "cli -m failed")
            with open(paf) as f:
                lines = [ln.rstrip("\n").split("\t") for ln in f]
        need(all(len(c) >= 12 for c in lines), "malformed PAF line")
        need(sorted(c[0] for c in lines) == sorted(r.read_id for r in sub),
             "PAF read names differ from the input reads")
        truth = {r.read_id: r for r in sub}
        mapped = [c for c in lines if c[5] != "*"]
        ok = sum(
            (c[4] == "+") == (truth[c[0]].strand == 1)
            and int(c[7]) < truth[c[0]].ref_end
            and int(c[8]) > truth[c[0]].ref_start
            for c in mapped
        )
        log(f"cli: {len(lines)} PAF lines, {len(mapped)} mapped, "
            f"{ok} correct")
        need(len(mapped) >= 0.98 * len(sub), "CLI mapped < 98% of reads")
        need(ok >= 0.99 * len(mapped), "CLI correct < 99% of mapped")


def run_four_cards(summary, sweep_cache_dir):
    """sweep_cache_dir: an empty scratch directory through which the three
    mappers share one sweep-store build.  The exact-engine rescue is off
    here: it is the same host code on every mesh, and without it every
    record comes from the device path under test."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu.parallel.turbo_shard import TurboShardMapper

    need(len(jax.devices()) >= 4, f"--four needs 4 GPUs, JAX has "
         f"{len(jax.devices())}")
    p = TurboParams(rescue=False)
    with phase("workload"):
        cfg, _pore, _genome, idx, reads, signals = workload(
            BATCH, 16, sweep_cache_dir=sweep_cache_dir)
    with phase("one card: TurboMapper on device 0"):
        t0 = time.perf_counter()
        records = TurboMapper(idx, cfg, p).streaming_map(signals)
        single = paf_lines(records, idx)
        mapped, correct = accuracy(records, reads)
        summary["single_mapped_correct"] = [mapped, correct]
        log(f"single: {len(single)} records, mapped {mapped}, correct "
            f"{correct} ({time.perf_counter() - t0:.1f} s incl. compile)")
    devs = np.array(jax.devices()[:4])
    for D, I in ((1, 4), (2, 2)):
        with phase(f"four cards: mesh data={D} x index={I}"):
            mesh = Mesh(devs.reshape(D, I), ("data", "index"))
            t0 = time.perf_counter()
            sharded = paf_lines(
                TurboShardMapper(idx, cfg, mesh, p).streaming_map(signals),
                idx)
            diff = sum(a != b for a, b in zip(single, sharded))
            log(f"mesh {D}x{I}: {len(sharded)} records, {diff} differ from "
                f"one card ({time.perf_counter() - t0:.1f} s incl. compile)")
            summary[f"mesh_{D}x{I}_records_differing"] = diff
            need(len(sharded) == len(single), "record counts differ")
            need(diff == 0, f"{diff} records differ from the one-card run")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    ap.add_argument("--swaps", action="store_true",
                    help="also time turbo_round with each kernel layer "
                         "swapped for its plain version, and all plain")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "sigmap_tpu")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(sigmap_tpu/ not found beside this script)")
    sys.path.insert(0, ROOT)
    import jax

    from sigmap_tpu.utils import enable_compilation_cache

    summary = {}
    with phase("device"):
        cache = enable_compilation_cache()
        dev = jax.devices()[0]
        need(dev.platform == "gpu",
             f"JAX found no GPU (platform {dev.platform}); nothing to smoke")
        smi = nvidia_smi()
        log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
            f"{len(jax.devices())} device(s); compile cache {cache}")
        summary["nvidia_smi"] = smi
    t0 = time.perf_counter()
    if args.four:
        with tempfile.TemporaryDirectory() as tmp:
            run_four_cards(summary, tmp)
    else:
        run_one_card(summary, args.swaps)
    summary["wall_s"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(
            OUT_DIR, "chip_smoke_four.json" if args.four
            else "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    log(f"nvidia-smi: {smi[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
