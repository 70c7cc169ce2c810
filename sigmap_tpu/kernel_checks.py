"""Kernel-vs-plain checks of each kernel layer, for the card and tests.

Each check runs one layer (sweep, chaining) twice on the same inputs,
once through the plain XLA version and once through the implementation
ops/impl.py picks for the backend (the Triton kernel on the GPU; tests may
name "triton_interpret"), compares the results within the layer's stated
tolerance, and returns the warmed-up times of both (ms, min over reps,
each call ended with block_until_ready).  A failed comparison raises
AssertionError.  chip_smoke.py calls these at the 12 Mb / B = 2048
widths; tests/test_gpu_kernels.py calls them on the card at smaller ones.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from .ops import impl as _impl

PLAIN = _impl.PLAIN
# tolerances, all in f32 (the rotation runs at HIGHEST precision)
SWEEP_BAND = 1e-4          # d^2 band around the radius / the K-th bound
SWEEP_D2_ATOL = 5e-4       # kept d^2 vs recomputed raw-space d^2
CHAIN_RTOL = 1e-5          # chain scores: relative


def timed(fn, *args, reps: int = 3):
    """(result, best ms over reps) of a warmed-up call."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def _pair(layer, kernel, make_fn, *args, reps=3):
    kern = _impl.choose(layer, kernel)
    a, t_plain = timed(make_fn(PLAIN), *args, reps=reps)
    b, t_kern = timed(make_fn(kern), *args, reps=reps)
    return a, b, {"layer": layer, "impl": kern, "plain_ms": t_plain,
                  "impl_ms": t_kern}


# ----------------------------------------------------------------- sweep --

def _kept(meta_row, d2_row, n):
    return {int(m): float(d) for m, d in zip(meta_row[:n], d2_row[:n])}


def compare_sweep(a, b, radius, K):
    """Match sets of two sweep results [Q, K] (meta, d2, cnt, wrote):
    equal outside the d^2 band of SWEEP_BAND around the radius and around
    a truncated seed's K-th kept d^2; shared matches' d^2 within
    SWEEP_D2_ATOL.  Returns the number of seeds whose exact totals differ
    (boundary pairs only)."""
    ma, da, ca, wa = (np.asarray(x) for x in a)
    mb, db, cb, wb = (np.asarray(x) for x in b)
    cnt_diff = int((ca != cb).sum())
    for i in np.nonzero((wa != wb) | (ma != mb).any(1)
                        | (np.abs(da - db) > 0).any(1))[0]:
        ka = _kept(ma[i], da[i], wa[i])
        kb = _kept(mb[i], db[i], wb[i])
        for m in ka.keys() & kb.keys():
            assert abs(ka[m] - kb[m]) < SWEEP_D2_ATOL, (i, m, ka[m], kb[m])
        bound = [radius]
        if wa[i] == K:
            bound.append(max(ka.values()))
        if wb[i] == K:
            bound.append(max(kb.values()))
        for m in ka.keys() ^ kb.keys():
            d = ka.get(m, kb.get(m))
            assert min(abs(d - x) for x in bound) < SWEEP_BAND, (
                f"seed {i}: match {m} d2={d} differs outside the band")
    assert cnt_diff <= max(1, len(ca) // 10000), (
        f"{cnt_diff} seeds' exact totals differ")
    return cnt_diff


def check_sweep(seeds, sw, p, radius, kernel=None, reps=3):
    """Sweep radius search: kernel vs plain on the same [Q, 8] raw seeds.
    sw: dict of device arrays (tiles, meta, cum, rot, mu, origin) and geom
    (radixes, span, cell_width)."""
    from .mapping.sweep_search import sweep_round

    radixes, span, cell_width = sw["geom"]

    def make(which):
        # the index arrays are arguments, not closed-over constants
        return jax.jit(lambda *a: sweep_round(
            *a, radius=radius, K=p.K, TILE=p.TILE, dim=sw["dim"],
            block=p.block, radixes=radixes, span=span,
            cell_width=cell_width, impl=which))

    a, b, res = _pair("sweep", kernel, make, seeds, sw["cum"], sw["tiles"],
                      sw["meta"], sw["rot"], sw["mu"], sw["origin"],
                      reps=reps)
    res["cnt_diff"] = compare_sweep(a, b, radius, p.K)
    res["seeds"] = int(seeds.shape[0])
    res["matches"] = int(np.asarray(a[2]).sum())
    return res, b


def check_sweep_oracle(seeds, result, index, radius, K, n=256):
    """The first n VALID seeds of a sweep result vs the native k-d tree
    (exact raw-space radius search, nanoflann semantics)."""
    from . import native
    from .index.sweep import META_POS_BITS
    from .mapping.sweep_search import SEED_PAD

    native.require()
    seeds = np.asarray(seeds)[:, : index.dim]
    rows = np.nonzero(seeds[:, 0] < SEED_PAD / 2)[0][:n]
    m_meta, m_d2, cnt, wrote = (np.asarray(x)[rows] for x in result)
    if index.win_group is None:
        index.derive_window_metadata()
    metas = ((index.win_group.astype(np.int64) << META_POS_BITS)
             | index.win_pos.astype(np.int64))
    tree = native.KdTree(index.values, index.dim, index.max_leaf)
    hi_r = radius + SWEEP_BAND
    fi, fd, fc = tree.radius_batch(seeds[rows], hi_r, per_cap=1 << 16)
    off = np.concatenate([[0], np.cumsum(fc)])
    for j in range(len(rows)):
        idx = fi[off[j]:off[j + 1]]
        d2 = fd[off[j]:off[j + 1]]
        ok = idx < index.n_windows
        idx, d2 = idx[ok], d2[ok]
        inner = d2 < radius - SWEEP_BAND
        assert inner.sum() <= cnt[j] <= len(d2), (j, cnt[j], inner.sum())
        by_meta = {int(metas[i]): float(d) for i, d in zip(idx, d2)}
        got = _kept(m_meta[j], m_d2[j], wrote[j])
        assert got.keys() <= by_meta.keys(), f"seed {j}: extra matches"
        for m, d in got.items():
            assert abs(by_meta[m] - d) < SWEEP_D2_ATOL, (j, m, d, by_meta[m])
        if wrote[j] < K:
            assert {int(metas[i]) for i in idx[inner]} <= got.keys(), j
        else:
            want = np.sort(d2)[:K]
            np.testing.assert_allclose(np.sort(list(got.values())), want,
                                       atol=SWEEP_D2_ATOL)
    return {"oracle_seeds": int(len(rows))}


# ----------------------------------------------------------------- chain --

def check_chain(args, radius, dim, ring, cfg, kb, kernel=None, reps=3,
                n_ref=4):
    """Fused chaining: integer fields equal, scores within CHAIN_RTOL;
    the first n_ref reads also against the numpy twin."""
    from .ops.chain_fused import chain_fused, chain_fused_ref

    def make(which):
        return jax.jit(lambda *a: chain_fused(
            *a, radius=radius, dim=dim, ring=ring, cfg=cfg, kb=kb,
            impl=which))

    a, b, res = _pair("chain", kernel, make, *args, reps=reps)
    _compare_chain(a, b, "plain vs impl")
    if n_ref:
        cols = np.arange(n_ref)
        ref = chain_fused_ref(*(np.asarray(x)[:, cols] for x in args),
                              radius=radius, dim=dim, ring=ring, cfg=cfg,
                              kb=kb)
        sub = (np.asarray(b[0])[:, cols], np.asarray(b[1])[:, cols],
               tuple(np.asarray(c)[:, cols] for c in b[2]))
        _compare_chain(ref, sub, "numpy twin vs impl", rows_f=4, rows_i=6)
    res["reads"] = int(args[0].shape[1])
    res["anchors"] = int((np.asarray(args[3]) >= 0).sum())
    return res, b


def _compare_chain(a, b, what, rows_f=8, rows_i=8):
    fa, ia, ca = a
    fb, ib, cb = b
    np.testing.assert_array_equal(np.asarray(ia)[:rows_i],
                                  np.asarray(ib)[:rows_i],
                                  err_msg=f"{what}: chain fields")
    np.testing.assert_allclose(np.asarray(fb)[:rows_f],
                               np.asarray(fa)[:rows_f], rtol=CHAIN_RTOL,
                               atol=1e-5, err_msg=f"{what}: chain scores")
    for k, (x, y) in enumerate(zip(ca, cb)):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == np.float32:
            np.testing.assert_allclose(y, x, rtol=CHAIN_RTOL, atol=1e-5,
                                       err_msg=f"{what}: carry {k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: carry {k}")


# ------------------------------------------------------------ pipeline --

def round_inputs(tm, signals):
    """Seed windows [B*S, 8] and qpos [B, S] of chunks 0 and 1 of one
    TurboMapper batch, as the rounds build them."""
    from .mapping.turbo import batch_features, build_seeds, quantize_batch

    m = tm.cfg.mapping
    p = tm.p
    B = len(signals)
    q, qoff, qscale, n_full = quantize_batch(signals, B, 2, m.chunk_size,
                                             m.max_num_chunks)
    feats, counts = batch_features(
        q, qoff, qscale, n_full, p=p, ed_cfg=tm.cfg.event,
        compress_delta=m.compress_delta)
    chunks = []
    offsets = jnp.zeros((B,), jnp.int32)
    for c in range(2):
        seeds, qpos, _, _ = build_seeds(
            feats[:, c], counts[:, c], offsets, p.S, m.step_size,
            tm.index.dim, m.min_feature_length)
        chunks.append((seeds.reshape(B * p.S, 8), qpos))
        offsets = offsets + counts[:, c]
    return chunks


def chain_args(sweep_out, qpos, carry, B, p):
    """chain_fused inputs from a sweep result and a carry tuple."""
    from .mapping.turbo import anchors_qpos_major

    m_meta, m_d2, _cnt, wrote = sweep_out
    n_t, n_q, n_d, n_g = anchors_qpos_major(m_meta, m_d2, wrote, qpos, B,
                                            p.S, p.K)
    c_t, c_q, c_g, c_score, c_stt, c_stq, c_n, c_sumd = carry
    return (
        jnp.concatenate([c_t, n_t]), jnp.concatenate([c_q, n_q]),
        jnp.concatenate([jnp.zeros((p.RING, B), jnp.float32), n_d]),
        jnp.concatenate([jnp.where(c_g == -2, -1, c_g), n_g]),
        c_score, c_stt, c_stq, c_n, c_sumd,
    )


def sweep_arrays(tm):
    return dict(tiles=tm.tiles, meta=tm.meta, cum=tm.cum, rot=tm.rot,
                mu=tm.mu, origin=tm.origin, geom=tm.geom, dim=tm.index.dim)


def run_all(tm, signals, kernel=None, reps=3, n_oracle=256, n_ref=4,
            log=print):
    """Every layer check on one batch of `signals` through mapper `tm`.
    Returns the list of per-layer result dicts."""
    cfg = tm.cfg
    p = tm.p
    m = cfg.mapping
    B = len(signals)
    chunks = round_inputs(tm, signals)
    out = []
    sw = sweep_arrays(tm)
    carry = tm._init_state(B)[4]
    for c, (seeds, qpos) in enumerate(chunks):
        r, res = check_sweep(seeds, sw, p, m.search_radius, kernel,
                             reps if c == 0 else 1)
        if c == 0:
            r.update(check_sweep_oracle(seeds, res, tm.index,
                                        m.search_radius, p.K, n_oracle))
            log(f"sweep: {r}")
            out.append(r)
        args = chain_args(res, qpos, carry, B, p)
        r, (_, _, carry) = check_chain(
            args, m.search_radius, tm.index.dim, p.RING, cfg.chain, p.K,
            kernel, reps if c == 1 else 1, n_ref=n_ref if c == 1 else 0)
        if c == 1:              # the chunk that chains onto a real carry
            log(f"chain: {r}")
            out.append(r)
    return out


def round_variants(tm, signals, reps=3, swaps=True, log=print):
    """One turbo_round (chunk 0) timed end to end with every kernel layer
    on its kept implementation ("kept", best of reps) and, with swaps,
    with every layer plain ("all_plain") and with one kernel layer swapped
    for plain ("<layer>_plain"; one timed call each); batch_features
    timed once.  Also returns memory_analysis() of both jits."""
    import dataclasses

    from .mapping.turbo import (
        batch_features, quantize_batch, slice_chunk, turbo_round,
    )

    m = tm.cfg.mapping
    B = len(signals)
    NC = tm._prepare_batch(signals)[4]
    q, qoff, qscale, n_full = (
        jnp.asarray(x) for x in quantize_batch(
            signals, B, NC, m.chunk_size, m.max_num_chunks))
    ev_args = (q, qoff, qscale, n_full)
    ev_kw = dict(p=tm.p, ed_cfg=tm.cfg.event, compress_delta=m.compress_delta)
    (feats, counts), t_ev = timed(lambda *a: batch_features(*a, **ev_kw),
                                  *ev_args, reps=reps)
    out = {"batch_features_ms": t_ev}
    log(f"batch_features [B={B}, NC={NC}]: {t_ev:.3f} ms")
    fr, cr = slice_chunk(feats, counts, np.int32(0))
    args = (tm.tiles, tm.meta, tm.cum, tm.rot, tm.mu, tm.origin, fr, cr,
            n_full, *tm._init_state(B))
    rd_kw = dict(step=m.step_size, radius=m.search_radius,
                 dim=tm.index.dim, geom=tm.geom, chain_cfg=tm.cfg.chain,
                 m=m)
    kernels = [lay for lay in _impl.LAYERS if _impl.choose(lay) != PLAIN]
    variants = {"kept": ()}
    if swaps:
        variants["all_plain"] = tuple((lay, PLAIN) for lay in _impl.LAYERS)
        for lay in kernels:
            variants[f"{lay}_plain"] = ((lay, PLAIN),)
    for name, ov in variants.items():
        pv = dataclasses.replace(tm.p, impls=ov)
        _, t = timed(lambda *a: turbo_round(*a, p=pv, **rd_kw), *args,
                     reps=reps if name == "kept" else 1)
        out[f"turbo_round_ms[{name}]"] = t
        log(f"turbo_round [{name}]: {t:.3f} ms")
    mem = {
        "turbo_round": turbo_round.lower(
            *args, p=tm.p, **rd_kw).compile().memory_analysis(),
        "batch_features": batch_features.lower(
            *ev_args, **ev_kw).compile().memory_analysis(),
    }
    return out, mem, {"B": B, "NC": NC}
