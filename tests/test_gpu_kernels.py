"""Each device layer's kept implementation vs its plain version, on the
card.  Marked `gpu`: they skip where JAX has no GPU.  Run them on the
card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py

The checks themselves live in sigmap_tpu/kernel_checks.py (chip_smoke.py
runs the same ones at the 12 Mb / B = 2048 widths); here they run on a
2 Mb genome with 256 reads.
"""

import dataclasses

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")


@pytest.fixture(scope="module")
def mapper_and_reads(gpu):
    from sigmap_tpu.config import SigmapConfig
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import ReferenceSequence
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu.mapping.turbo import TurboMapper
    from sigmap_tpu.synth import random_genome, simulate_reads

    cfg = SigmapConfig()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=256))
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(2_000_000, seed=1)
    idx = build_index([ReferenceSequence(n, c) for n, c in genome], pore,
                      cfg.index, cfg.mapping.search_radius, verbose=False)
    reads = simulate_reads(pore, genome, 256, seed=2, read_bases=3000)
    signals = [
        ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
                   dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
        for r in reads
    ]
    return TurboMapper(idx, cfg), signals


@pytest.fixture(scope="module")
def inputs(mapper_and_reads):
    from sigmap_tpu import kernel_checks as kc

    tm, signals = mapper_and_reads
    return kc.round_inputs(tm, signals)


def test_sweep_kernel_matches_plain_and_oracle(mapper_and_reads, inputs):
    from sigmap_tpu import kernel_checks as kc

    tm, _ = mapper_and_reads
    seeds, _ = inputs[0]
    radius = tm.cfg.mapping.search_radius
    _, res = kc.check_sweep(seeds, kc.sweep_arrays(tm), tm.p, radius,
                            reps=1)
    kc.check_sweep_oracle(seeds, res, tm.index, radius, tm.p.K, n=128)


def test_chain_kernel_matches_plain_and_twin(mapper_and_reads, inputs):
    from sigmap_tpu import kernel_checks as kc
    from sigmap_tpu.mapping.sweep_search import sweep_round

    tm, signals = mapper_and_reads
    p, m = tm.p, tm.cfg.mapping
    seeds, qpos = inputs[0]
    radixes, span, cell_width = tm.geom
    res = sweep_round(seeds, tm.cum, tm.tiles, tm.meta, tm.rot, tm.mu,
                      tm.origin, radius=m.search_radius, K=p.K, TILE=p.TILE,
                      dim=tm.index.dim, block=p.block, radixes=radixes,
                      span=span, cell_width=cell_width)
    B = len(signals)
    args = kc.chain_args(res, qpos, tm._init_state(B)[4], B, p)
    kc.check_chain(args, m.search_radius, tm.index.dim, p.RING,
                   tm.cfg.chain, p.K, reps=1, n_ref=2)
