#!/usr/bin/env python
"""Turbo-vs-exact concordance + simulation-truth accuracy at scale.

Runs both streaming engines on the same simulated workload (default:
512 reads on a 12 Mb genome — the reference quickstart's yeast scale,
/root/reference/README.md:17-23) and reports:

* locus concordance: same strand + ref + |tstart delta| <= slack;
* mapped/unmapped decision agreement, mapq mean absolute delta,
  ci (chunks-to-decision) mean absolute delta — the adaptive-sampling
  latency metric (eval/eval.py:107-110);
* simulation-truth precision/recall/F1 for each engine
  (sigmap_tpu.evaluate protocol).

Writes PARITY_TURBO.json; PARITY.md quotes these numbers.

Usage: python tools_concordance.py [--genome-mb 12] [--reads 512]
       [--k 8] [--batch 512]
"""
import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def oracle_records(idx, cfg, signals, threads=8):
    """Truly exact records: native k-d tree + host chaining (the
    reference's 5000-anchor cap), emission mirroring
    Mapper._finish_streaming (sigmap.cc:690-866)."""
    from concurrent.futures import ThreadPoolExecutor

    from sigmap_tpu.io.paf import ChainsSummary, PAFRecord, streaming_tags
    from sigmap_tpu.mapping.chain import POSITIVE
    from sigmap_tpu.oracle import Oracle

    m = cfg.mapping
    oracle = Oracle(idx, cfg)

    def one(item):
        rid, s = item
        ci_adj, num_events, ch, _stopped = oracle.streaming_read(s.pa)
        ci = ci_adj + 1
        scale = 0.0
        if num_events > 0:
            scale = (ci * m.chunk_size / num_events) / (
                m.sample_rate / m.bp_per_sec
            )
        mean = sum(c.score for c in ch) / len(ch) if ch else 0.0
        out_ok = (
            len(ch) >= 2
            and (
                ch[0].score / ch[1].score >= m.output_mapping_ratio
                or ch[0].score >= m.output_mapping_mean_ratio * mean
            )
        ) or (
            len(ch) == 1
            and ch[0].num_anchors >= m.output_mapping_min_num_anchors
        )
        sl = s.length
        summ = None
        if ch:
            best = ch[0]
            a = best.anchors
            summ = ChainsSummary(
                num_anchors=best.num_anchors, num_chains=len(ch),
                s1=best.score,
                s2=ch[1].score if len(ch) > 1 else 0.0, sm=mean,
                ad=float(a["dist"].sum()) / best.num_anchors,
                at=float((a["target"][:-1] - a["target"][1:]).sum())
                / best.num_anchors,
                aq=float((a["query"][:-1] - a["query"][1:]).sum())
                / best.num_anchors,
            )
        tags = streaming_tags(0.0, ci, sl, summ)
        if not out_ok:
            return PAFRecord(
                read_id=rid, read_name=s.read_id, read_length=sl,
                read_start=0, read_end=0, ref_index=0, fragment_start=0,
                fragment_length=0, mapq=61, direction=0, tags=tags,
            )
        best = ch[0]
        ref_len = idx.ref_lengths[best.ref_index]
        tstart = (
            best.start_position if best.direction == POSITIVE
            else ref_len + 1 - best.end_position
        )
        return PAFRecord(
            read_id=rid, read_name=s.read_id, read_length=sl,
            read_start=int(scale * best.anchors["query"][-1]),
            read_end=int(scale * best.anchors["query"][0]),
            ref_index=best.ref_index, fragment_start=int(tstart),
            fragment_length=int(
                best.end_position - best.start_position + 1
            ),
            mapq=best.mapq,
            direction=1 if best.direction == POSITIVE else 0,
            tags=tags,
        )

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(one, enumerate(signals)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=12.0)
    ap.add_argument("--reads", type=int, default=512)
    ap.add_argument("--read-bases", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--k", type=int, default=None,
                    help="TurboParams.K override")
    ap.add_argument("--ring", type=int, default=None,
                    help="TurboParams.RING override")
    ap.add_argument("--slack", type=int, default=500)
    ap.add_argument("--out", default="PARITY_TURBO.json")
    ap.add_argument("--dump", default=None,
                    help="per-read CSV (locus delta, ci both engines)")
    ap.add_argument("--exact-engine", choices=["oracle", "device"],
                    default="oracle",
                    help="oracle = native k-d tree + host chains (truly "
                         "exact, reference 5000-anchor cap); device = "
                         "Mapper.streaming_map (its candidate caps "
                         "truncate on dense indexes)")
    args = ap.parse_args()

    import dataclasses
    import io

    from sigmap_tpu.config import SigmapConfig
    from sigmap_tpu.evaluate import evaluate_against_truth
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import ReferenceSequence
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu.mapping.driver import Mapper
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu.synth import random_genome, simulate_reads
    from sigmap_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    cfg = SigmapConfig()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(
            cfg.runtime, read_batch=args.batch, num_threads=4,
            sweep_cache_dir=os.path.join(
                os.path.dirname(os.path.abspath(__file__)), ".sweep_cache"),
        )
    )
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(int(args.genome_mb * 1e6), seed=1)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    t0 = time.perf_counter()
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    log(f"index: {time.perf_counter()-t0:.1f}s")
    reads = simulate_reads(pore, genome, args.reads, seed=2,
                           read_bases=args.read_bases)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]

    import jax

    params = None
    if args.k is not None or args.ring is not None:
        dflt = TurboParams()
        params = TurboParams(K=args.k or dflt.K, RING=args.ring or dflt.RING)
    tm = TurboMapper(idx, cfg, params)
    tm.streaming_map(signals[: min(64, len(signals))])   # warmup (compile)
    t0 = time.perf_counter()
    turbo = tm.streaming_map(signals)
    t_turbo = time.perf_counter() - t0
    log(f"turbo: {t_turbo:.1f}s ({len(signals)/t_turbo:.1f} reads/s)")

    t0 = time.perf_counter()
    if args.exact_engine == "device":
        exact = Mapper(idx, cfg).streaming_map(signals)
    else:
        exact = oracle_records(idx, cfg, signals)
    t_exact = time.perf_counter() - t0
    log(f"exact[{args.exact_engine}]: {t_exact:.1f}s "
        f"({len(signals)/t_exact:.1f} reads/s)")

    tb = {r.read_name: r for r in turbo}
    ex = {r.read_name: r for r in exact}

    def tag(rec, key, cast):
        probe = f"{key}:"
        for t in rec.tags.split("\t"):
            if t.startswith(probe):
                return cast(t.split(":", 2)[2])
        return None

    n = len(reads)
    both_mapped = both_unmapped = decision_diff = 0
    locus_agree = 0
    mapq_d, ci_d = [], []
    rows = []
    for r in reads:
        a = tb.get(r.read_id)
        b = ex.get(r.read_id)
        if a is None or b is None:
            decision_diff += 1
            continue
        ca, cb = tag(a, "ci", int), tag(b, "ci", int)
        if ca is not None and cb is not None:
            ci_d.append(abs(ca - cb))
        if a.is_mapped and b.is_mapped:
            both_mapped += 1
            same = (
                a.direction == b.direction
                and a.ref_index == b.ref_index
                and abs(a.fragment_start - b.fragment_start) <= args.slack
            )
            locus_agree += int(same)
            mapq_d.append(abs(a.mapq - b.mapq))
            rows.append((r.read_id, int(same),
                         abs(a.fragment_start - b.fragment_start),
                         ca, cb))
        elif not a.is_mapped and not b.is_mapped:
            both_unmapped += 1
        else:
            decision_diff += 1
    if args.dump:
        with open(args.dump, "w") as f:
            f.write("read,locus_same,tstart_delta,ci_turbo,ci_exact\n")
            for row in rows:
                f.write(",".join(str(x) for x in row) + "\n")

    buf = io.StringIO()
    res_t = evaluate_against_truth(turbo, reads, out=buf)
    res_e = evaluate_against_truth(exact, reads, out=buf)

    report = {
        "genome_mb": args.genome_mb,
        "n_reads": n,
        "turbo_k": (params.K if params else TurboParams().K),
        "slack_bp": args.slack,
        # environment: turbo throughput is a device figure only on a GPU
        "environment": {
            "jax_backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "exact_engine": args.exact_engine,
        },
        "both_mapped": both_mapped,
        "both_unmapped": both_unmapped,
        "decision_disagree": decision_diff,
        "locus_concordance": round(locus_agree / max(1, both_mapped), 4),
        "mapq_mean_abs_delta": round(float(np.mean(mapq_d)), 2) if mapq_d else None,
        "ci_mean_abs_delta": round(float(np.mean(ci_d)), 3) if ci_d else None,
        "ci_equal_pct": round(
            100.0 * float(np.mean(np.asarray(ci_d) == 0)), 1
        ) if ci_d else None,
        "turbo": {"precision": round(res_t.precision, 4),
                  "recall": round(res_t.recall, 4),
                  "f1": round(res_t.f1, 4),
                  "reads_per_s": round(n / t_turbo, 2)},
        "exact": {"precision": round(res_e.precision, 4),
                  "recall": round(res_e.recall, 4),
                  "f1": round(res_e.f1, 4),
                  "reads_per_s": round(n / t_exact, 2)},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
