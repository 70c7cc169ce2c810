"""Fused banded chaining + chain selection + carry: plain XLA and Triton.

The turbo engine's back half.  One pass over a read-batch's anchors
computes, per read: the best chain (score + locus + stats), the
second- and third-best non-overlapping chain scores, and the carry-out
chain state for the next streaming chunk — with NO anchor sort and NO
traceback:

* anchors arrive in qpos-major order ([B, seeds, K-slots] flattened),
  which is a valid topological order of the chaining DAG (every
  predecessor has strictly smaller qpos, and the reference's gates require
  qdiff > 0 AND tdiff > 0, spatial_index.cc:495-539) — so the tpos sort
  the reference needs (spatial_index.cc:410-417) is unnecessary here;
* the band is the ring of the last RING *valid* anchors per read, the
  device analogue of the reference's 5000-predecessor band;
* instead of parent pointers + traceback (spatial_index.cc:165-220), each
  anchor's DP state carries its chain's (start_t, start_q, n_anchors,
  sum_dist) inherited from the argmax predecessor — the best end anchor
  then already holds every statistic the PAF tags need;
* carry-out is the final ring: the last RING valid anchor states, which
  next round's anchors can chain onto (the streaming anchor accumulation
  of spatial_index.cc:302-322, restricted to the chain frontier; the
  driver keeps a running best-so-far summary so early best chains are
  never lost).

The serial DP over anchor blocks has two implementations (ops/impl.py
picks one): ``_dp_plain``, a ``lax.scan`` over [KB, B] anchor blocks with
the ring as [RING, B] arrays, and ``_dp_triton``, one Pallas program per
read (lowered through Triton) that holds its ring in registers across the
whole loop.  Pushing the carried rows and the chain selection passes are
plain array code shared by both.

Gates/scores match the reference exactly (spatial_index.cc:284-291,
495-539), with the gap-scale gates written as products (qdiff < scale *
tdiff) instead of a quotient: identical for the default scales and the
gated tdiff range, and free of the GPU's approximate division.
Divergences from the exact path (band size, frontier carry, three-chain
selection) are fast-mode approximations, documented in mapping/turbo.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ChainingConfig
from . import impl as _impl

NEG = -1.0e30
T_EMPTY = -(1 << 30)      # ring target position of an empty slot
# ring field order: (score, t, q, g, start_t, start_q, n, sumd)
_RING_FILL = (NEG, T_EMPTY, 0, -2, 0, 0, 0, 0.0)
_RING_DT = (jnp.float32, jnp.int32, jnp.int32, jnp.int32, jnp.int32,
            jnp.int32, jnp.int32, jnp.float32)
# best-chain field order: (s, g, t_end, q_end, start_t, start_q, n, sumd)
_BEST_FILL = (NEG, -1, 0, 0, 0, 0, 0, 0.0)
_BEST_DT = _RING_DT


def _carry_in(a_t, a_q, a_g, c_score, c_stt, c_stq, c_n, c_sumd, ring):
    """Push the carried rows (0..CARRY-1) into an empty ring.

    Row-at-a-time pushing keeps the last `ring` valid rows, valid row j
    landing in slot j % ring; this is that, as one scatter.  Returns
    (ring fields, cursor [B], best-chain fields, per-row scores and
    start_t [CARRY, B])."""
    CARRY, B = c_score.shape
    t, q, g = a_t[:CARRY], a_q[:CARRY], a_g[:CARRY]
    v = g >= 0
    s = jnp.where(v, c_score, NEG)
    rank = jnp.cumsum(v, axis=0, dtype=jnp.int32) - 1
    n_valid = jnp.sum(v, axis=0, dtype=jnp.int32)
    keep = v & (rank >= n_valid[None, :] - ring)
    slot = jnp.where(keep, rank % ring, ring)            # ring = dropped
    col = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32), (CARRY, B))
    rows = (s, t, q, jnp.where(v, g, -2), c_stt, c_stq, c_n, c_sumd)
    ring_f = tuple(
        jnp.full((ring, B), fill, dt).at[slot, col].set(r, mode="drop")
        for fill, dt, r in zip(_RING_FILL, _RING_DT, rows)
    )
    # best_update over rows in order takes strictly greater scores: the
    # first row holding the maximum wins
    bi = jnp.argmax(s, axis=0)
    take = jnp.max(s, axis=0) > NEG
    best_rows = (s, g, t, q, c_stt, c_stq, c_n, c_sumd)
    best = tuple(
        jnp.where(take, jnp.take_along_axis(r, bi[None, :], 0)[0],
                  jnp.asarray(fill, dt))
        for r, fill, dt in zip(best_rows, _BEST_FILL, _BEST_DT)
    )
    return ring_f, n_valid, best, s, c_stt


def _gates(t, q, d, g, r_t, r_q, r_g, *, radius, dim, cfg):
    """Predecessor gates and chaining increments of anchors (t, q, d, g)
    against ring entries (broadcasting); returns (coef, ok, match_dim)."""
    coef = 1.0 - d * np.float32(0.2 / radius)
    tdiff = t - r_t
    qdiff = q - r_q
    tf = tdiff.astype(jnp.float32)
    qf = qdiff.astype(jnp.float32)
    ok = (
        (r_g == g) & (tdiff > 0) & (qdiff > 0)
        & (r_t + cfg.max_target_gap_length >= t)
        & (jnp.abs(tdiff - qdiff) < cfg.max_gap_length)
        & (qf < np.float32(cfg.max_gap_scale) * tf)
        & (qf > np.float32(cfg.min_gap_scale) * tf)
    )
    match_dim = jnp.minimum(jnp.minimum(tdiff, qdiff), dim).astype(
        jnp.float32) * coef
    return coef, ok, match_dim


def _dp_plain(a_t, a_q, a_d, a_g, ring_f, cur, best, *, KB, radius, dim,
              cfg):
    """lax.scan over [KB, B] anchor blocks (rows CARRY.. of the inputs).

    All KB rows of a block share one seed's qpos, so they cannot chain
    onto each other (the gates need qdiff > 0, spatial_index.cc:511) and
    all read the ring as of the block start; they are then pushed in row
    order.  Returns (ring fields, best fields, scores [R, B], start_t
    [R, B]) for the R = A - CARRY rows."""
    R, B = a_t.shape
    RING = ring_f[0].shape[0]
    kio = jax.lax.broadcasted_iota(jnp.int32, (RING, B), 0)
    kio3 = jax.lax.broadcasted_iota(jnp.int32, (KB, RING, B), 1)

    def block(carry, xs):
        ring, cur, best = carry
        t, q, d, g = xs                                  # [KB, B]
        r_score, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sumd = ring
        v = g >= 0
        coef, ok, md = _gates(
            t[:, None], q[:, None], d[:, None], g[:, None],
            r_t[None], r_q[None], r_g[None],
            radius=radius, dim=dim, cfg=cfg,
        )
        coef = coef[:, 0]
        init = coef * dim
        cand = jnp.where(ok, r_score[None] + md, NEG)    # [KB, RING, B]
        bestc = jnp.max(cand, axis=1)
        bi = jnp.min(jnp.where(cand == bestc[:, None], kio3, RING), axis=1)
        sel = kio3 == bi[:, None]

        def extract(arr):
            return jnp.sum(jnp.where(sel, arr[None], 0).astype(arr.dtype),
                           axis=1)

        chained = v & (bestc > init)
        s = jnp.where(v, jnp.where(chained, bestc, init), NEG)
        stt = jnp.where(chained, extract(r_stt), t)
        stq = jnp.where(chained, extract(r_stq), q)
        n = jnp.where(chained, extract(r_n) + 1, 1)
        sumd = jnp.where(chained, extract(r_sumd) + d, d)
        gv = jnp.where(v, g, -2)
        for k in range(KB):
            row = (s[k], g[k], t[k], q[k], stt[k], stq[k], n[k], sumd[k])
            take = row[0] > best[0]
            best = tuple(jnp.where(take, a, b) for a, b in zip(row, best))
            hit = (kio == (cur % RING)[None, :]) & v[k][None, :]
            vals = (s[k], t[k], q[k], gv[k], stt[k], stq[k], n[k], sumd[k])
            ring = tuple(jnp.where(hit, x[None, :], r)
                         for r, x in zip(ring, vals))
            cur = cur + v[k].astype(jnp.int32)
        return (ring, cur, best), (s, stt)

    nblk = R // KB
    xs = tuple(x.reshape(nblk, KB, B) for x in (a_t, a_q, a_d, a_g))
    (ring_f, _, best), (sc, stt) = jax.lax.scan(
        block, (ring_f, cur, best), xs
    )
    return ring_f, best, sc.reshape(R, B), stt.reshape(R, B)


def _dp_kernel(at_ref, aq_ref, ad_ref, ag_ref, ring_in, cur_ref, bf_in,
               bi_in, ring_out, bf_out, bi_out, sc_ref, stt_ref,
               *, R, KB, RING, RP, radius, dim, cfg):
    """One read: the DP loop with the ring held in registers."""
    b = pl.program_id(0)
    kio = jax.lax.broadcasted_iota(jnp.int32, (RP,), 0)
    kcol = jax.lax.broadcasted_iota(jnp.int32, (KB,), 0)
    ring0 = tuple(r[b, :] for r in ring_in)
    best0 = (bf_in[b, 0], bi_in[b, 0], bi_in[b, 1], bi_in[b, 2],
             bi_in[b, 3], bi_in[b, 4], bi_in[b, 5], bf_in[b, 1])

    def block(blk, carry):
        ring, cur, best = carry
        r_score, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sumd = ring
        rows = []
        for k in range(KB):
            i = blk * KB + k
            t, q, d, g = at_ref[b, i], aq_ref[b, i], ad_ref[b, i], ag_ref[b, i]
            v = g >= 0
            coef, ok, md = _gates(t, q, d, g, r_t, r_q, r_g,
                                  radius=radius, dim=dim, cfg=cfg)
            init = coef * dim
            cand = jnp.where(ok, r_score + md, NEG)
            bestc = jnp.max(cand)
            sel = kio == jnp.argmax(cand).astype(jnp.int32)
            chained = v & (bestc > init)
            s = jnp.where(v, jnp.where(chained, bestc, init), NEG)
            stt = jnp.where(chained, jnp.sum(jnp.where(sel, r_stt, 0)), t)
            stq = jnp.where(chained, jnp.sum(jnp.where(sel, r_stq, 0)), q)
            n = jnp.where(chained, jnp.sum(jnp.where(sel, r_n, 0)) + 1, 1)
            sumd = jnp.where(
                chained, jnp.sum(jnp.where(sel, r_sumd, 0.0)) + d, d)
            rows.append((v, s, g, t, q, stt, stq, n, sumd))
        s_vec = jnp.zeros((KB,), jnp.float32)
        stt_vec = jnp.zeros((KB,), jnp.int32)
        for k, (v, s, g, t, q, stt, stq, n, sumd) in enumerate(rows):
            take = s > best[0]
            best = tuple(jnp.where(take, a, b_)
                         for a, b_ in zip((s, g, t, q, stt, stq, n, sumd),
                                          best))
            hit = (kio == cur % RING) & v
            vals = (s, t, q, jnp.where(v, g, -2), stt, stq, n, sumd)
            ring = tuple(jnp.where(hit, x, r) for r, x in zip(ring, vals))
            cur = cur + v.astype(jnp.int32)
            s_vec = jnp.where(kcol == k, s, s_vec)
            stt_vec = jnp.where(kcol == k, stt, stt_vec)
        sc_ref[b, pl.ds(blk * KB, KB)] = s_vec
        stt_ref[b, pl.ds(blk * KB, KB)] = stt_vec
        return ring, cur, best

    ring, _, best = jax.lax.fori_loop(
        0, R // KB, block, (ring0, cur_ref[b], best0)
    )
    for r_out, r in zip(ring_out, ring):
        r_out[b, :] = r
    s, g, te, qe, stt, stq, n, sumd = best
    bf_out[b, 0] = s
    bf_out[b, 1] = sumd
    for j, x in enumerate((g, te, qe, stt, stq, n)):
        bi_out[b, j] = x


def _dp_triton(a_t, a_q, a_d, a_g, ring_f, cur, best, *, KB, radius, dim,
               cfg, interpret=False):
    """Pallas/Triton twin of _dp_plain: one program per read over [B, R]
    (anchor-major per read, so each program's loads are contiguous) with
    the ring padded to a power of two; padding slots hold an empty group
    (-2) and never match."""
    R, B = a_t.shape
    RING = ring_f[0].shape[0]
    RP = 1 << (RING - 1).bit_length()
    if KB & (KB - 1):
        raise ValueError(f"Triton chaining needs a power-of-two kb ({KB})")
    ring_in = tuple(
        jnp.pad(r.T, ((0, 0), (0, RP - RING)), constant_values=fill)
        for r, fill in zip(ring_f, _RING_FILL)
    )
    s, g, te, qe, stt, stq, n, sumd = best
    bf_in = jnp.stack([s, sumd], axis=1)
    bi_in = jnp.stack([g, te, qe, stt, stq, n], axis=1)
    out_shape = (
        [jax.ShapeDtypeStruct((B, RP), dt) for dt in _RING_DT]
        + [jax.ShapeDtypeStruct((B, 2), jnp.float32),
           jax.ShapeDtypeStruct((B, 6), jnp.int32),
           jax.ShapeDtypeStruct((B, R), jnp.float32),
           jax.ShapeDtypeStruct((B, R), jnp.int32)]
    )

    def kernel(at, aq, ad, ag, *refs):
        ring_i, (cur_r, bf_i, bi_i) = refs[:8], refs[8:11]
        ring_o, (bf_o, bi_o, sc_o, stt_o) = refs[11:19], refs[19:]
        _dp_kernel(at, aq, ad, ag, ring_i, cur_r, bf_i, bi_i, ring_o, bf_o,
                   bi_o, sc_o, stt_o, R=R, KB=KB, RING=RING, RP=RP,
                   radius=radius, dim=dim, cfg=cfg)

    outs = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=out_shape,
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        name="chain_dp",
    )(a_t.T, a_q.T, a_d.T, a_g.T, *ring_in, cur, bf_in, bi_in)
    ring_o = tuple(o[:, :RING].T for o in outs[:8])
    bf_o, bi_o, sc, stt_o = outs[8:]
    best = (bf_o[:, 0], bi_o[:, 0], bi_o[:, 1], bi_o[:, 2], bi_o[:, 3],
            bi_o[:, 4], bi_o[:, 5], bf_o[:, 1])
    return ring_o, best, sc.T, stt_o.T


def _select(scores, stt, a_t, a_g, best):
    """Chains 2 and 3 over every anchor's end state [A, B].

    Chain 2: best score among anchors whose chain's target interval
    [stt, t] does NOT overlap chain 1's [stt1, te1] on the same reference
    sequence (GeneratePrimaryChains' overlap rule compares ref index only,
    spatial_index.cc:233-247; interval overlap — not just the endpoint —
    is what excludes sub/extension chains sharing chain 1's anchors, the
    device stand-in for traceback's used-anchor score subtraction,
    spatial_index.cc:165-220).  Chain 3 (the reference keeps up to
    num_best_chains=3, spatial_index.cc:289): best score among anchors
    overlapping NEITHER chain 1 NOR chain 2, where chain 2 is the first
    row holding s2.  Primary-chain candidacy gates (score >=
    min_chaining_score, score > max/2 traceback gate, /3 primary break,
    spatial_index.cc:230-247,545-546) are applied by the caller on the
    returned raw maxima."""
    _, g1, te1, _, stt1, _, _, _ = best
    grp = a_g >> 1
    excl1 = (grp == (g1 >> 1)[None]) & (
        jnp.maximum(stt, stt1[None]) <= jnp.minimum(a_t, te1[None]))
    s2 = jnp.max(jnp.where(excl1, NEG, scores), axis=0)
    hit = ~excl1 & (scores == s2[None]) & (scores > NEG * 0.5)
    first = jnp.argmax(hit, axis=0)[None, :]
    found2 = jnp.any(hit, axis=0)
    g2 = jnp.take_along_axis(a_g, first, 0)[0]
    stt2 = jnp.take_along_axis(stt, first, 0)[0]
    te2 = jnp.take_along_axis(a_t, first, 0)[0]
    excl2 = found2[None] & (grp == (g2 >> 1)[None]) & (
        jnp.maximum(stt, stt2[None]) <= jnp.minimum(a_t, te2[None]))
    s3 = jnp.max(jnp.where(excl1 | excl2, NEG, scores), axis=0)
    return s2, s3


@partial(
    jax.jit,
    static_argnames=("radius", "dim", "ring", "cfg", "kb", "impl"),
)
def chain_fused(
    a_t: jax.Array,      # [A, B] i32 (rows 0..CARRY-1 are carried anchors)
    a_q: jax.Array,      # [A, B] i32
    a_d: jax.Array,      # [A, B] f32 squared distances
    a_g: jax.Array,      # [A, B] i32 group (ref*2+strand), -1 = invalid
    c_score: jax.Array,  # [CARRY, B] f32 carried chain scores
    c_stt: jax.Array,    # [CARRY, B] i32
    c_stq: jax.Array,    # [CARRY, B] i32
    c_n: jax.Array,      # [CARRY, B] i32
    c_sumd: jax.Array,   # [CARRY, B] f32
    radius: float,
    dim: int = 6,
    ring: int = 64,
    cfg: ChainingConfig = ChainingConfig(),
    kb: int = 1,
    impl: str | None = None,
):
    """Returns (sum_f [8, B] f32, sum_i [8, B] i32, carry-out tuple of 8
    [ring, B] arrays (t, q, g, score, start_t, start_q, n, sumd)).

    sum_f rows: 0 s1, 1 s2 (best non-overlapping), 2 sumd1, 3 s3 (best
    overlapping neither chain 1 nor chain 2), 4..7 zero.  sum_i rows: 0
    g1, 1 t_start, 2 t_end, 3 q_start, 4 q_end, 5 n1, 6..7 zero.  s2/s3
    are RAW maxima; the caller applies the reference's primary-chain
    candidacy gates (min_chaining_score, the traceback score > max/2 gate
    and the /3 primary break, spatial_index.cc:230-247,545-546).

    kb: rows processed per DP step.  Anchor rows arrive as K-slot runs per
    seed (same qpos), so kb = K is legal (same-seed rows can't chain onto
    each other) and cuts the serial depth K-fold; rows within one
    kb-block read the ring as of the block start.  impl: see ops/impl.py
    (None = the backend's default)."""
    A, B = a_t.shape
    CARRY = c_score.shape[0]
    if (A - CARRY) % kb:
        raise ValueError(f"anchor rows {A - CARRY} must tile by kb={kb}")
    ring_f, cur, best, sc_c, stt_c = _carry_in(
        a_t, a_q, a_g, c_score, c_stt, c_stq, c_n, c_sumd, ring
    )
    dp_in = tuple(x[CARRY:] for x in (a_t, a_q, a_d, a_g))
    kw = dict(KB=kb, radius=radius, dim=dim, cfg=cfg)
    which = _impl.choose("chain", impl)
    if which == _impl.PLAIN:
        ring_f, best, sc, stt = _dp_plain(*dp_in, ring_f, cur, best, **kw)
    else:
        ring_f, best, sc, stt = _dp_triton(
            *dp_in, ring_f, cur, best,
            interpret=which == _impl.TRITON_INTERPRET, **kw,
        )
    scores = jnp.concatenate([sc_c, sc], axis=0)
    stt_all = jnp.concatenate([stt_c, stt], axis=0)
    s2, s3 = _select(scores, stt_all, a_t, a_g, best)
    s1, g1, te1, qe1, stt1, stq1, n1, sumd1 = best
    zf = jnp.zeros((B,), jnp.float32)
    zi = jnp.zeros((B,), jnp.int32)
    sum_f = jnp.stack([s1, s2, sumd1, s3, zf, zf, zf, zf])
    sum_i = jnp.stack([g1, stt1, te1, stq1, qe1, n1, zi, zi])
    r_score, r_t, r_q, r_g, r_stt, r_stq, r_n, r_sumd = ring_f
    return sum_f, sum_i, (r_t, r_q, r_g, r_score, r_stt, r_stq, r_n, r_sumd)


def chain_fused_ref(a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd,
                    radius, dim=6, ring=64, cfg=ChainingConfig(), kb=1):
    """Numpy executable twin of chain_fused (per-read serial), for tests."""
    A, B = a_t.shape
    CARRY = c_score.shape[0]
    sum_f = np.zeros((8, B), np.float32)
    sum_i = np.zeros((8, B), np.int32)
    co = [np.zeros((ring, B), dt) for dt in
          (np.int32, np.int32, np.int32, np.float32, np.int32, np.int32,
           np.int32, np.float32)]  # t q g score stt stq n sumd
    co[2][:] = -2
    co[3][:] = NEG
    co[0][:] = -(1 << 30)
    for b in range(B):
        states = []   # (score, t, q, g, stt, stq, n, sumd) per row
        for i in range(A):
            t, q, d, g = a_t[i, b], a_q[i, b], a_d[i, b], a_g[i, b]
            if g < 0:
                states.append(None)
                continue
            if i < CARRY:
                states.append((float(c_score[i, b]), t, q, g,
                               c_stt[i, b], c_stq[i, b], c_n[i, b],
                               float(c_sumd[i, b])))
                continue
            coef = 1.0 - 0.2 * float(d) / radius
            init = coef * dim
            # predecessors = ring state at this row's kb-block start (rows
            # within one block share a seed/qpos and can't chain anyway)
            bs = CARRY + ((i - CARRY) // kb) * kb
            prev = [s for s in states[:bs] if s is not None][-ring:]
            best, besti = NEG, -1
            for s in prev:
                ps, pt, pq, pg = s[0], s[1], s[2], s[3]
                tdiff, qdiff = int(t) - int(pt), int(q) - int(pq)
                if pg != g or tdiff <= 0 or qdiff <= 0:
                    continue
                if pt + cfg.max_target_gap_length < t:
                    continue
                gap = abs(tdiff - qdiff)
                gs = qdiff / tdiff
                if (gap >= cfg.max_gap_length or gs >= cfg.max_gap_scale
                        or gs <= cfg.min_gap_scale):
                    continue
                cand = ps + min(tdiff, qdiff, dim) * coef
                if cand > best:
                    best, besti = cand, s
            if besti != -1 and best > init:
                states.append((np.float32(best), t, q, g, besti[4], besti[5],
                               besti[6] + 1, besti[7] + float(d)))
            else:
                states.append((np.float32(init), t, q, g, t, q, 1, float(d)))
        live = [s for s in states if s is not None]
        if live:
            bi = int(np.argmax([s[0] for s in live]))
            s1, t1, q1, g1, stt, stq, n1, sumd = live[bi]
            sum_f[0, b], sum_f[2, b] = s1, sumd
            sum_i[:6, b] = (g1, stt, t1, stq, q1, n1)
            s2 = NEG
            for s in live:
                if (s[3] // 2 == g1 // 2
                        and max(s[4], stt) <= min(s[1], t1)):
                    continue
                s2 = max(s2, s[0])
            sum_f[1, b] = s2
            # chain 2 = FIRST state (row order) achieving s2 under the
            # chain-1 exclusion mask; chain 3 = best state overlapping
            # neither (chain_fused's selection passes)
            c2 = None
            if s2 > NEG * 0.5:
                for s in live:
                    if (s[3] // 2 == g1 // 2
                            and max(s[4], stt) <= min(s[1], t1)):
                        continue
                    if s[0] == s2:
                        c2 = s
                        break
            s3 = NEG
            for s in live:
                if (s[3] // 2 == g1 // 2
                        and max(s[4], stt) <= min(s[1], t1)):
                    continue
                if c2 is not None and (
                    s[3] // 2 == c2[3] // 2
                    and max(s[4], c2[4]) <= min(s[1], c2[1])
                ):
                    continue
                s3 = max(s3, s[0])
            sum_f[3, b] = s3
        else:
            sum_f[0, b] = NEG
            sum_f[1, b] = NEG
            sum_f[3, b] = NEG
            sum_i[0, b] = -1
        tail = live[-ring:]
        for k, s in enumerate(tail):
            slot = (len(live) - len(tail) + k) % ring
            co[3][slot, b] = s[0]
            co[0][slot, b] = s[1]
            co[1][slot, b] = s[2]
            co[2][slot, b] = s[3]
            co[4][slot, b] = s[4]
            co[5][slot, b] = s[5]
            co[6][slot, b] = s[6]
            co[7][slot, b] = s[7]
    return sum_f, sum_i, tuple(co)
