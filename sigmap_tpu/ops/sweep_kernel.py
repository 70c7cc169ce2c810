"""Streaming merge-join radius search ("sweep"): plain XLA and Triton.

The replacement for per-seed k-d traversal
(/root/reference/src/spatial_index.cc:366, nanoflann).  The round's seeds
arrive sorted by their coarse grid cell key (mapping/sweep_search.py), so a
block of consecutive seeds probes a narrow, contiguous band of the
cell-sorted window store (index/sweep.py).  For each block, the UNION of
its candidate tile ranges is streamed tile by tile; every (seed, window)
pair gets an exact f32 squared distance accumulated as sum_d (w_d - q_d)^2
(nanoflann's own formula) and the strict d^2 < radius test
(nanoflann.hpp:249).  Union slop only adds evaluations that fail the test,
never changes the match set.

Per seed the K SMALLEST d^2 are kept (the true-locus match, usually the
minimum of a crowded ball, survives truncation), with exact total match
counts so K-truncation is observable.  The kernel breaks d^2 ties by the
window's meta; the plain version by scan order.  Callers get the slots
sorted by (d^2, meta) (sort_slots).

Two implementations share that contract (ops/impl.py picks one):

* ``_sweep_plain``: a loop over the largest per-block tile count; each
  step gathers every block's next tile (blocks past their count are
  masked), computes the [Q, TILE] distances and merges them into the
  running K-best with ``lax.top_k`` over [K + TILE].
* ``_sweep_triton``: one Pallas program per seed block, lowered through
  Triton.  The program loads its own row of the block table, loops over
  its own tile count (no skew), evaluates [block, SUB] sub-tiles in
  registers and inserts candidates below the running K-th bound one
  minimum at a time (at most K + 1 inserts per sub-tile and row).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import impl as _impl

INF = np.float32(1.0e30)
IMAX = np.int32(2**31 - 1)
SUB = 128           # Triton sub-tile width: [block, SUB] distances in registers


def _sweep_plain(seeds, blockmeta, tiles, meta, *, radius, K, TILE, dim,
                 block):
    Q = seeds.shape[0]
    G = Q // block
    NO = (blockmeta.shape[1] - 1) // 2
    starts = blockmeta[:, :NO]                         # [G, NO]
    cums = blockmeta[:, NO:]                           # [G, NO+1]
    total = cums[:, NO]                                # [G]
    q = seeds.reshape(G, block, 8)
    rad = np.float32(radius)

    def step(s, carry):
        kd, km, cnt = carry
        valid = s < total
        # offset containing flat step s: the last offset whose cumsum <= s
        oo = jnp.sum(cums[:, 1:NO] <= s, axis=1)[:, None]
        t = (jnp.take_along_axis(starts, oo, 1)
             + s - jnp.take_along_axis(cums, oo, 1))[:, 0]
        t = jnp.where(valid, t, 0)
        w = jnp.take(tiles, t, axis=0)                 # [G, 8, TILE]
        mt = jnp.take(meta, t, axis=0)                 # [G, TILE]
        d2 = jnp.zeros((G, block, TILE), jnp.float32)
        for d in range(dim):
            diff = w[:, None, d, :] - q[:, :, d, None]
            d2 = d2 + diff * diff
        match = (d2 < rad) & valid[:, None, None]
        cnt = cnt + match.sum(axis=2).reshape(Q).astype(jnp.int32)
        cand = jnp.where(match, d2, INF).reshape(Q, TILE)
        neg, idx = jax.lax.top_k(-jnp.concatenate([kd, cand], axis=1), K)
        from_old = idx < K
        old_m = jnp.take_along_axis(km, jnp.minimum(idx, K - 1), axis=1)
        new_m = jnp.take_along_axis(
            mt[:, None, :], jnp.maximum(idx - K, 0).reshape(G, block, K),
            axis=2,
        ).reshape(Q, K)
        return -neg, jnp.where(from_old, old_m, new_m), cnt

    kd, km, cnt = jax.lax.fori_loop(
        0, jnp.max(total, initial=0), step,
        (jnp.full((Q, K), INF), jnp.zeros((Q, K), jnp.int32),
         jnp.zeros((Q,), jnp.int32)),
    )
    kept = kd < INF
    return (jnp.where(kept, km, 0), jnp.where(kept, kd, 0.0), cnt,
            kept.sum(axis=1).astype(jnp.int32))


def _sweep_kernel(bm_ref, seeds_ref, tiles_ref, meta_ref,
                  om_ref, od_ref, ocnt_ref, ow_ref,
                  *, radius, K, KP, TILE, dim, block, n_offsets):
    g = pl.program_id(0)
    NO = n_offsets
    starts = [bm_ref[g, oo] for oo in range(NO)]
    cums = [bm_ref[g, NO + oo] for oo in range(NO + 1)]
    total = cums[NO]
    rows = pl.ds(g * block, block)
    q = [seeds_ref[d, rows] for d in range(dim)]        # dim x [block]
    col = jax.lax.broadcasted_iota(jnp.int32, (block, SUB), 1)
    kcol = jax.lax.broadcasted_iota(jnp.int32, (block, KP), 1)
    rad = np.float32(radius)

    def insert(carry):
        """Move each row's smallest candidate, by (d^2, meta), into its
        K-best if it beats the row's worst kept (d^2, meta) (open slots
        hold (INF, 0) and are filled first); a row whose smallest fails is
        done for this sub-tile.  Windows' metas are unique, so the kept
        set is the K smallest by (d^2, meta) whatever the scan order."""
        cand, mt, kd, km = carry
        mn = jnp.min(cand, axis=1)
        at_mn = cand == mn[:, None]
        mv = jnp.min(jnp.where(at_mn, mt[None, :], IMAX), axis=1)
        hit = at_mn & (mt[None, :] == mv[:, None])
        worst = jnp.max(kd, axis=1)
        at_worst = kd == worst[:, None]
        wm = jnp.max(jnp.where(at_worst, km, -1), axis=1)
        wi = jnp.argmax((at_worst & (km == wm[:, None])).astype(jnp.int32),
                        axis=1).astype(jnp.int32)
        put = (mn < rad) & ((mn < worst) | ((mn == worst) & (mv < wm)))
        khit = (kcol == wi[:, None]) & put[:, None]
        kd = jnp.where(khit, mn[:, None], kd)
        km = jnp.where(khit, mv[:, None], km)
        cand = jnp.where(hit | ~put[:, None], INF, cand)
        return cand, mt, kd, km

    def tile_step(s, carry):
        kd, km, cnt = carry
        t = starts[0] + s
        for oo in range(1, NO):
            t = jnp.where(cums[oo] <= s, starts[oo] + (s - cums[oo]), t)
        for j in range(TILE // SUB):
            cols = pl.ds(j * SUB, SUB)
            acc = jnp.zeros((block, SUB), jnp.float32)
            for d in range(dim):
                diff = tiles_ref[t, d, cols][None, :] - q[d][:, None]
                acc = acc + diff * diff
            match = acc < rad
            cnt = cnt + jnp.sum(match.astype(jnp.int32), axis=1)
            # <= : a tie with the worst kept d^2 may still win on meta
            tau = jnp.max(kd, axis=1)
            cand = jnp.where(match & (acc <= tau[:, None]), acc, INF)
            mt = meta_ref[t, cols]
            _, _, kd, km = jax.lax.while_loop(
                lambda c: jnp.min(c[0]) < INF, insert, (cand, mt, kd, km)
            )
        return kd, km, cnt

    # slots K..KP-1 pad K to a power of two: they hold -1 (below every
    # d^2), so they are never the worst slot, and are cut off outside
    kd0 = jnp.where(kcol < K, INF, -1.0)
    kd, km, cnt = jax.lax.fori_loop(
        0, total, tile_step,
        (kd0, jnp.zeros((block, KP), jnp.int32),
         jnp.zeros((block,), jnp.int32)),
    )
    kept = (kd < INF) & (kcol < K)
    om_ref[rows, :] = jnp.where(kept, km, 0)
    od_ref[rows, :] = jnp.where(kept, kd, 0.0)
    ocnt_ref[rows] = cnt
    ow_ref[rows] = jnp.sum(kept.astype(jnp.int32), axis=1)


def _sweep_triton(seeds, blockmeta, tiles, meta, *, radius, K, TILE, dim,
                  block, interpret=False):
    Q = seeds.shape[0]
    G = Q // block
    if TILE % SUB or block & (block - 1):
        raise ValueError(
            f"Triton sweep needs TILE % {SUB} == 0 and a power-of-two "
            f"block (TILE={TILE}, block={block})"
        )
    KP = 1 << (K - 1).bit_length()
    n_offsets = (blockmeta.shape[1] - 1) // 2
    m_meta, m_d2, cnt, wrote = pl.pallas_call(
        partial(_sweep_kernel, radius=radius, K=K, KP=KP, TILE=TILE,
                dim=dim, block=block, n_offsets=n_offsets),
        grid=(G,),
        out_shape=[
            jax.ShapeDtypeStruct((Q, KP), jnp.int32),
            jax.ShapeDtypeStruct((Q, KP), jnp.float32),
            jax.ShapeDtypeStruct((Q,), jnp.int32),
            jax.ShapeDtypeStruct((Q,), jnp.int32),
        ],
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        name="sweep_search",
    )(blockmeta, seeds.T, tiles, meta)
    return m_meta[:, :K], m_d2[:, :K], cnt, wrote


def sort_slots(m_meta, m_d2, n_kept):
    """Order each row's first n_kept slots by (d^2, meta) and zero the
    rest: a canonical slot order, so chaining (which pushes a seed's
    anchors in slot order) sees the same anchors in the same order from
    every search path (either implementation, one device or a sharded
    merge)."""
    K = m_meta.shape[1]
    kept = jnp.arange(K)[None, :] < n_kept[:, None]
    d2, mm = jax.lax.sort(
        (jnp.where(kept, m_d2, INF), jnp.where(kept, m_meta, IMAX)),
        dimension=1, num_keys=2,
    )
    return jnp.where(kept, mm, 0), jnp.where(kept, d2, 0.0)


@partial(jax.jit, static_argnames=("K", "TILE", "radius", "dim", "block",
                                  "impl"))
def sweep_search(
    seeds: jax.Array,      # [Q, 8] f32, Q multiple of block, cell-key SORTED
    blockmeta: jax.Array,  # [Q//block, 2*NO+1] i32: cols 0..NO-1 first tile
                           # per (block, offset); cols NO..2*NO tile cumsum
    tiles: jax.Array,      # [T, 8, TILE] f32
    meta: jax.Array,       # [T, TILE] i32
    radius: float,
    K: int = 16,
    TILE: int = 1024,
    dim: int = 6,
    block: int = 32,
    impl: str | None = None,
):
    """Returns (m_meta [Q, K] i32, m_d2 [Q, K] f32, cnt [Q] i32, wrote
    [Q] i32).

    cnt = exact total matches (the reference's per-seed anchor count
    before its 5000 cap, spatial_index.cc:290); wrote = slots actually
    filled (== min(cnt, K)).  Filled slots come first, sorted by (d^2,
    meta); empty slots hold 0.  impl: see ops/impl.py (None = the
    backend's default)."""
    kw = dict(radius=radius, K=K, TILE=TILE, dim=dim, block=block)
    which = _impl.choose("sweep", impl)
    if which == _impl.PLAIN:
        m_meta, m_d2, cnt, wrote = _sweep_plain(
            seeds, blockmeta, tiles, meta, **kw)
    else:
        m_meta, m_d2, cnt, wrote = _sweep_triton(
            seeds, blockmeta, tiles, meta,
            interpret=which == _impl.TRITON_INTERPRET, **kw,
        )
    return (*sort_slots(m_meta, m_d2, wrote), cnt, wrote)
