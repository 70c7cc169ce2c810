"""Multi-chip turbo: record-for-record PAF equality vs single chip.

Runs on the virtual 8-device CPU mesh (conftest.py).  The merged search
keeps the K smallest d^2 across index shards, which only differs from
single-chip when a seed exceeds K matches — K is sized so the test
workload never truncates, making equality exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.paf import mapped_line, unmapped_line
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
from sigmap_tpu.synth import random_genome, simulate_reads


@pytest.fixture(scope="module")
def workload():
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(80_000, seed=21)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    reads = simulate_reads(pore, genome, 8, seed=6, read_bases=2200)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return cfg, idx, signals


def _paf_lines(records, ref_names, ref_lengths, drop_mt=True):
    lines = []
    for r in sorted(records, key=lambda x: x.read_id):
        if r.is_mapped:
            line = mapped_line(r, ref_names[r.ref_index],
                               ref_lengths[r.ref_index])
        else:
            line = unmapped_line(r)
        if drop_mt:
            # mt:f is wall-clock, legitimately differs between runs
            line = "\t".join(
                f for f in line.split("\t") if not f.startswith("mt:")
            )
        lines.append(line)
    return lines


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
def test_turbo_shard_paf_equals_single(workload, mesh_shape):
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu.parallel.turbo_shard import TurboShardMapper

    cfg, idx, signals = workload
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=8)
    )
    p = TurboParams(S=256, K=32, RING=64, TILE=256)
    single = TurboMapper(idx, cfg, p).streaming_map(signals)

    D, I = mesh_shape
    mesh = Mesh(np.array(jax.devices()[: D * I]).reshape(D, I),
                ("data", "index"))
    sharded = TurboShardMapper(idx, cfg, mesh, p).streaming_map(signals)

    ref_names = idx.ref_names
    ref_lengths = idx.ref_lengths
    a = _paf_lines(single, ref_names, ref_lengths)
    b = _paf_lines(sharded, ref_names, ref_lengths)
    assert len(a) == len(b) == len(signals)
    for la, lb in zip(a, b):
        assert la == lb
