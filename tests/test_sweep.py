"""Sweep search: exact match-set parity with brute force / the oracle.

Both search implementations (plain XLA, and the Triton kernel in interpret
mode) run the same checks.  The sweep stores windows in PCA-ROTATED
coordinates (index/sweep.py) and accumulates d^2 directly in f32; rotation
is an exact isometry, but f32 rounding means pairs within a tiny band of
the radius boundary can flip vs a raw-space oracle.  Assertions are therefore band-tolerant: matches
strictly inside radius - EPS must all be found, nothing outside
radius + EPS may be reported, and boundary pairs may go either way.
"""

import numpy as np
import pytest

from sigmap_tpu.config import SigmapConfig
from sigmap_tpu.index.build import build_index
from sigmap_tpu.index.sweep import SweepIndex
from sigmap_tpu.io.fasta import ReferenceSequence
from sigmap_tpu.io.pore_model import make_synthetic_pore_model
from sigmap_tpu.mapping.sweep_search import SEED_PAD, sweep_round
from sigmap_tpu.synth import random_genome

EPS = 1e-4
IMPLS = ["plain", "triton_interpret"]


@pytest.fixture(scope="module")
def small_index():
    cfg = SigmapConfig()
    pore = make_synthetic_pore_model(k=6, seed=0)
    genome = random_genome(20000, seed=3)
    seqs = [ReferenceSequence(n, c) for n, c in genome]
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                      verbose=False)
    return cfg, idx


def _raw_windows_by_meta(idx):
    """meta value -> raw-space window coords, from the SignalIndex."""
    if idx.win_group is None:
        idx.derive_window_metadata()
    from sigmap_tpu.index.sweep import META_POS_BITS

    W = np.lib.stride_tricks.sliding_window_view(idx.values, idx.dim)
    metas = (
        (idx.win_group.astype(np.int64) << META_POS_BITS)
        | idx.win_pos.astype(np.int64)
    )
    return W[: idx.n_windows], metas[: idx.n_windows]


@pytest.mark.parametrize("impl", IMPLS)
def test_sweep_matches_brute(small_index, impl):
    import jax.numpy as jnp

    cfg, idx = small_index
    radius = cfg.mapping.search_radius
    sw = SweepIndex.build(idx, radius, tile=256)
    W, metas = _raw_windows_by_meta(idx)
    rng = np.random.default_rng(0)
    # queries: noisy copies of real windows (some matches guaranteed),
    # plus pure noise, plus padding
    Q = 64
    picks = rng.integers(0, sw.n_windows, Q // 2)
    qs = np.zeros((Q, 8), np.float32)
    qs[: Q // 2, : idx.dim] = W[picks] + rng.normal(
        0, 0.08, (Q // 2, idx.dim)).astype(np.float32)
    qs[Q // 2 : -8, : idx.dim] = rng.normal(
        0, 1, (Q // 2 - 8, idx.dim)).astype(np.float32)
    qs[-8:, : idx.dim] = SEED_PAD

    K = 48
    m_meta, m_d2, cnt, wrote = sweep_round(
        jnp.asarray(qs), jnp.asarray(sw.cum), jnp.asarray(sw.tiles),
        jnp.asarray(sw.meta), jnp.asarray(sw.rot), jnp.asarray(sw.mu),
        jnp.asarray(sw.origin), radius=radius, K=K, TILE=sw.tile,
        radixes=sw.radixes, span=sw.span, cell_width=sw.cell_width,
        impl=impl,
    )
    m_meta = np.asarray(m_meta)
    m_d2 = np.asarray(m_d2)
    cnt = np.asarray(cnt)
    wrote = np.asarray(wrote)

    for i in range(Q - 8):
        d2 = ((W - qs[i, None, : idx.dim]) ** 2).sum(axis=1)
        inner = d2 < radius - EPS
        outer = d2 < radius + EPS
        want_inner = {int(m) for m in metas[inner]}
        want_outer = {int(m) for m in metas[outer]}
        got = {int(m) for m in m_meta[i, : wrote[i]]}
        assert inner.sum() <= cnt[i] <= outer.sum(), f"seed {i}"
        if outer.sum() <= K:
            assert want_inner <= got <= want_outer, f"seed {i}"
        else:
            assert got <= want_outer, f"seed {i}"
        # distances exact up to rotated-basis f32 rounding
        meta_to_d2 = {int(m): d for m, d in zip(metas, d2)}
        for s in range(wrote[i]):
            assert abs(meta_to_d2[int(m_meta[i, s])] - m_d2[i, s]) < 5e-4
    # padded seeds: no matches
    assert (cnt[-8:] == 0).all()
    assert (wrote[-8:] == 0).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_sweep_dense_cluster_truncation(small_index, impl):
    """Seeds whose matches exceed K: exact totals, wrote == min(total, K)."""
    import jax.numpy as jnp

    cfg, idx = small_index
    radius = cfg.mapping.search_radius
    sw = SweepIndex.build(idx, radius, tile=256)
    W, _metas = _raw_windows_by_meta(idx)
    # a zero query in z-scored space sits near many windows
    qs = np.zeros((32, 8), np.float32)
    m_meta, m_d2, cnt, wrote = sweep_round(
        jnp.asarray(qs), jnp.asarray(sw.cum), jnp.asarray(sw.tiles),
        jnp.asarray(sw.meta), jnp.asarray(sw.rot), jnp.asarray(sw.mu),
        jnp.asarray(sw.origin), radius=radius, K=8, TILE=sw.tile,
        radixes=sw.radixes, span=sw.span, cell_width=sw.cell_width,
        impl=impl,
    )
    d2 = ((W - qs[0, None, : idx.dim]) ** 2).sum(axis=1)
    lo = int((d2 < radius - EPS).sum())
    hi = int((d2 < radius + EPS).sum())
    assert lo <= int(np.asarray(cnt)[0]) <= hi
    assert (np.asarray(wrote) <= 8).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_sweep_truncation_keeps_closest_k(small_index, impl):
    """When a seed's ball holds more than K matches, the K kept slots must
    be the K SMALLEST d^2 (up to the f32 rotated-basis boundary band) —
    the guarantee that the true-locus match survives truncation."""
    import jax.numpy as jnp

    cfg, idx = small_index
    # a WIDE radius so balls at 20 kb scale hold well over K matches
    radius = 0.8
    sw = SweepIndex.build(idx, radius, tile=256)
    W, metas = _raw_windows_by_meta(idx)
    rng = np.random.default_rng(7)
    Q = 32
    picks = rng.integers(0, sw.n_windows, Q)
    qs = np.zeros((Q, 8), np.float32)
    qs[:, : idx.dim] = W[picks] + rng.normal(
        0, 0.1, (Q, idx.dim)).astype(np.float32)
    K = 4
    m_meta, m_d2, cnt, wrote = sweep_round(
        jnp.asarray(qs), jnp.asarray(sw.cum), jnp.asarray(sw.tiles),
        jnp.asarray(sw.meta), jnp.asarray(sw.rot), jnp.asarray(sw.mu),
        jnp.asarray(sw.origin), radius=radius, K=K, TILE=sw.tile,
        radixes=sw.radixes, span=sw.span, cell_width=sw.cell_width,
        impl=impl,
    )
    m_d2 = np.asarray(m_d2)
    cnt = np.asarray(cnt)
    wrote = np.asarray(wrote)
    checked = 0
    for i in range(Q):
        d2 = np.sort(((W - qs[i, None, : idx.dim]) ** 2).sum(axis=1))
        d2 = d2[d2 < radius]
        if len(d2) <= K:
            continue
        checked += 1
        kept = np.sort(m_d2[i, : wrote[i]])
        assert wrote[i] == K
        # kept set = K smallest within the f32 boundary band
        np.testing.assert_allclose(kept, d2[:K], atol=5e-4)
    assert checked >= 3, "test inputs produced too few crowded balls"


def test_sweep_implementations_agree_slot_for_slot(small_index):
    """Under heavy truncation both implementations return the same kept
    matches in the same (d^2, meta) slot order: chaining pushes a seed's
    anchors in slot order, so the order is part of the result."""
    import jax.numpy as jnp

    cfg, idx = small_index
    radius = 0.8
    sw = SweepIndex.build(idx, radius, tile=256)
    W, _metas = _raw_windows_by_meta(idx)
    rng = np.random.default_rng(11)
    Q = 64
    qs = np.zeros((Q, 8), np.float32)
    qs[:, : idx.dim] = W[rng.integers(0, sw.n_windows, Q)] + rng.normal(
        0, 0.1, (Q, idx.dim)).astype(np.float32)
    outs = [
        [np.asarray(x) for x in sweep_round(
            jnp.asarray(qs), jnp.asarray(sw.cum), jnp.asarray(sw.tiles),
            jnp.asarray(sw.meta), jnp.asarray(sw.rot), jnp.asarray(sw.mu),
            jnp.asarray(sw.origin), radius=radius, K=4, TILE=sw.tile,
            radixes=sw.radixes, span=sw.span, cell_width=sw.cell_width,
            impl=impl,
        )]
        for impl in IMPLS
    ]
    (m1, d1, c1, w1), (m2, d2, c2, w2) = outs
    assert (w1 == 4).sum() >= 8, "too few truncated seeds"
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(d1, d2)
    kept = np.arange(4)[None, :] < w1[:, None]
    key = np.where(kept, d1, np.inf)
    assert (np.diff(key, axis=1) >= 0).all()
