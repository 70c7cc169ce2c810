"""Turbo engine end-to-end: correct loci on synthetic reads + concordance
with the exact streaming path."""

import dataclasses

import numpy as np
import pytest

from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import random_genome, simulate_reads


@pytest.fixture(scope="module")
def workload():
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(200_000, seed=11)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    reads = simulate_reads(pore, genome, 100, seed=5, read_bases=2000)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return cfg, idx, reads, signals


def test_turbo_maps_synthetic_reads(workload):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx, reads, signals = workload
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=32)
    )
    tm = TurboMapper(idx, cfg, TurboParams(S=256, K=16, RING=64, TILE=256))
    records = tm.streaming_map(signals)
    assert len(records) == len(signals)
    by_name = {rec.read_name: rec for rec in records}
    correct = 0
    for r in reads:
        rec = by_name[r.read_id]
        if not rec.is_mapped:
            continue
        lo = rec.fragment_start
        hi = lo + rec.fragment_length
        if rec.direction == r.strand and lo < r.ref_end and hi > r.ref_start:
            correct += 1
    assert correct >= len(reads) - 2, f"only {correct}/{len(reads)} correct"


def test_turbo_concordance_with_exact(workload):
    """Locus agreement between turbo and the exact streaming path."""
    from sigmap_tpu.mapping.driver import Mapper
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx, reads, signals = workload
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=32)
    )
    exact = Mapper(idx, cfg).streaming_map(signals)
    turbo = TurboMapper(
        idx, cfg, TurboParams(S=256, K=16, RING=64, TILE=256)
    ).streaming_map(signals)
    ex = {r.read_name: r for r in exact}
    tb = {r.read_name: r for r in turbo}
    agree = 0
    both = 0
    for name, e in ex.items():
        t = tb.get(name)
        if t is None or not (e.is_mapped and t.is_mapped):
            continue
        both += 1
        e_lo, e_hi = e.fragment_start, e.fragment_start + e.fragment_length
        t_lo, t_hi = t.fragment_start, t.fragment_start + t.fragment_length
        if (e.ref_index == t.ref_index and e.direction == t.direction
                and t_lo < e_hi + 500 and t_hi > e_lo - 500):
            agree += 1
    assert both >= len(reads) - 5
    # >= 98%: K-truncation (nearest-K anchor slots vs the reference's
    # 5000 cap) may flip rare repeat-ambiguous loci
    assert agree >= 0.98 * both, f"{agree}/{both} loci agree"


def test_turbo_rescue_recovers_truncation(workload):
    """With a deliberately tiny K (heavy per-seed truncation), the exact
    rescue pass must recover reads turbo unmaps: no silent capacity
    unmapping (reference keeps 5000/seed, spatial_index.cc:290)."""
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams

    cfg, idx0, reads, signals = workload
    # a wide radius crowds every ball so K=2 truncates hard (at 200 kb the
    # default radius leaves balls near-empty and truncation can't bite);
    # reads subset keeps the CPU run fast
    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, search_radius=0.5),
        runtime=dataclasses.replace(
            cfg.runtime, read_batch=32, num_threads=2),
    )
    idx = build_index(
        [ReferenceSequence(n, c) for n, c in random_genome(200_000, seed=11)],
        make_synthetic_pore_model(k=6, seed=0),
        cfg.index, cfg.mapping.search_radius, verbose=False,
    )
    signals = signals[:32]
    reads = reads[:32]
    # S=16/K=1: seed AND match truncation both bite (closest-K made K=2
    # at full S strong enough to map everything here)
    base = dict(S=16, K=1, RING=64, TILE=256)
    no_rescue = TurboMapper(
        idx, cfg, TurboParams(rescue=False, **base)
    ).streaming_map(signals)
    rescued = TurboMapper(
        idx, cfg, TurboParams(rescue=True, **base)
    ).streaming_map(signals)
    n_plain = sum(r.is_mapped for r in no_rescue)
    n_resc = sum(r.is_mapped for r in rescued)
    # tiny K must unmap some reads without rescue; rescue restores them
    assert n_plain < len(signals), "K=2 unexpectedly mapped everything"
    assert n_resc > n_plain
    assert n_resc >= len(signals) - 2, f"{n_resc}/{len(signals)} after rescue"
    # rescued records carry exact-engine loci: check against truth
    by_name = {rec.read_name: rec for rec in rescued}
    for r in reads:
        rec = by_name[r.read_id]
        if not rec.is_mapped:
            continue
        lo = rec.fragment_start
        hi = lo + rec.fragment_length
        assert rec.direction != r.strand or lo < r.ref_end or hi > r.ref_start
