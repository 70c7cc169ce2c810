"""XLA-side preparation for the sweep search kernel.

Per round: rotate seeds into the index's PCA basis (index/sweep.py), sort
them by lo-corner cell key (block locality), compute per (seed-block,
offset) union tile ranges from the dense cumulative cell table, run
ops/sweep_kernel.sweep_search, and map results back to the original seed
order.

Semantics: identical match set to the reference k-d radius search
(strict d^2 < radius, spatial_index.cc:366 + nanoflann.hpp:249), with
per-seed output truncated to K slots (the reference caps at 5000/seed,
spatial_index.cc:290); exact totals are returned so truncation is
observable.  One caveat: d^2 is accumulated as sum((q'-w')^2) in f32 in
the ROTATED basis, while nanoflann accumulates (q-w)^2 in the raw basis —
rotation is an exact isometry, but f32 rounding means pairs within ~1e-5
(relative) of the radius boundary can flip between the two (tests use a
boundary-band tolerance accordingly).
"""

from __future__ import annotations

from functools import partial
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sweep_kernel import sweep_search

BIG = np.int32(2**31 - 1)
# Padded/invalid seeds: dims < index.dim set to SEED_PAD; after rotation
# they land far outside the grid (clipped to the trailing edge cell) and
# their d^2 dominates every radius test, so they never match.
SEED_PAD = 2.0e9


def rotate(x: jax.Array, mu: jax.Array, rot: jax.Array) -> jax.Array:
    """[N, dim] raw coords -> the index's PCA basis, (x - mu) @ rot.

    HIGHEST keeps the product in full f32: a GPU may otherwise run an f32
    matmul in TF32 (~10 mantissa bits), and the strict d^2 < radius test
    would then disagree with the host-rotated window store
    (index/sweep.py) far outside the f32 rounding band."""
    return jnp.matmul(x - mu[None, :], rot,
                      precision=jax.lax.Precision.HIGHEST)


def seed_cell_bounds(qr: jax.Array, radius: float, w: float, origin,
                     radixes: tuple, span: int):
    """[Q, bd] ROTATED seed coords -> per-offset (key_lo, key_hi), each
    [Q, span^(bd-1)] i32.

    Offsets enumerate the leading bd-1 bucketed dims (the L2 ball spans
    <= span cells per dim); the last bucketed dim's cell span is folded
    into each offset's contiguous key range."""
    bd = len(radixes)
    delta = np.float32(np.sqrt(radius))
    wf = np.float32(w)
    rx = [np.int32(r) for r in radixes]
    lo = jnp.clip(
        jnp.floor((qr - delta - origin) / wf).astype(jnp.int32),
        0, jnp.asarray(radixes, jnp.int32)[None, :] - 1,
    )
    hi = jnp.clip(
        jnp.floor((qr + delta - origin) / wf).astype(jnp.int32),
        0, jnp.asarray(radixes, jnp.int32)[None, :] - 1,
    )
    klos, khis = [], []
    for offs in itertools.product(range(span), repeat=bd - 1):
        cs = [lo[:, d] + offs[d] for d in range(bd - 1)]
        ok = cs[0] <= hi[:, 0]
        for d in range(1, bd - 1):
            ok &= cs[d] <= hi[:, d]
        key_lo = cs[0]
        for d in range(1, bd - 1):
            key_lo = key_lo * rx[d] + cs[d]
        key_lo = key_lo * rx[bd - 1] + lo[:, bd - 1]
        key_hi = key_lo + (hi[:, bd - 1] - lo[:, bd - 1])
        klos.append(jnp.where(ok, key_lo, BIG))
        khis.append(jnp.where(ok, key_hi, -1))
    return jnp.stack(klos, axis=1), jnp.stack(khis, axis=1)


@partial(jax.jit, static_argnames=("K", "TILE", "radius", "dim",
                                  "block", "radixes", "span", "cell_width",
                                  "impl"))
def sweep_round(
    seeds: jax.Array,     # [Q, 8] f32 RAW coords (invalid seeds = SEED_PAD)
    cum: jax.Array,       # [prod(radixes)+1] i32 cumulative cell table
    tiles: jax.Array,     # [T, 8, TILE] f32 (rotated coords)
    meta: jax.Array,      # [T, TILE] i32
    rot: jax.Array,       # [dim, dim] f32 PCA rotation
    mu: jax.Array,        # [dim] f32 rotation center
    origin: jax.Array,    # [bd] f32 grid origin (rotated coords)
    radius: float,
    K: int = 16,
    TILE: int = 1024,
    dim: int = 6,
    block: int = 32,
    radixes: tuple = (),
    span: int = 3,
    cell_width: float = 0.2828427,
    impl: str | None = None,
):
    """Full radius search for one round's seeds, in ORIGINAL seed order.

    Returns (m_meta [Q, K] i32, m_d2 [Q, K] f32, cnt [Q] i32 exact totals,
    wrote [Q] i32 slots filled).  impl names the search implementation
    (ops/impl.py; None = the backend's default)."""
    Q0 = seeds.shape[0]
    if Q0 % block:
        pad = block - Q0 % block
        prow = jnp.where(jnp.arange(8) < dim, np.float32(SEED_PAD), 0.0)
        seeds = jnp.concatenate(
            [seeds, jnp.broadcast_to(prow, (pad, 8))], axis=0
        )
    Q = seeds.shape[0]
    bd = len(radixes)
    NO = span ** (bd - 1)  # probe offsets
    w = np.float32(cell_width)
    delta = np.float32(np.sqrt(radius))
    # rotate into the index basis; rows >= dim stay zero
    qr_d = rotate(seeds[:, :dim], mu, rot)               # [Q, dim]
    qr8 = jnp.concatenate(
        [qr_d, jnp.zeros((Q, 8 - dim), jnp.float32)], axis=1
    )
    qb = qr_d[:, :bd]
    # Sort seeds by the LO-CORNER cell key (cell of q - delta), not the
    # nominal cell: every probe offset is then a CONSTANT key shift across
    # a block, so block unions stay as tight as the block's own key span.
    rxs = jnp.asarray(radixes, jnp.int32)
    qc = jnp.clip(
        jnp.floor((qb - delta - origin) / w).astype(jnp.int32),
        0, rxs[None, :] - 1,
    )
    skey = qc[:, 0]
    for d in range(1, bd):
        skey = skey * np.int32(radixes[d]) + qc[:, d]
    _, perm = jax.lax.sort(
        (skey, jnp.arange(Q, dtype=jnp.int32)), num_keys=1
    )
    qr_s = jnp.take(qr8, perm, axis=0)
    iperm = jnp.zeros((Q,), jnp.int32).at[perm].set(
        jnp.arange(Q, dtype=jnp.int32)
    )
    klo, khi = seed_cell_bounds(
        jnp.take(qb, perm, axis=0), radius, w, origin, radixes, span
    )  # [Q, NO]
    G = Q // block
    bmin = klo.reshape(G, block, NO).min(axis=1)      # [G, NO]
    bmax = khi.reshape(G, block, NO).max(axis=1)
    CS = cum.shape[0] - 1
    start = cum[jnp.clip(bmin, 0, CS)]
    end = cum[jnp.clip(bmax + 1, 0, CS)]
    empty = (bmax < bmin) | (end <= start)
    nt = tiles.shape[0]
    t0 = jnp.where(empty, nt, start // TILE)             # empty sorts last
    t1 = jnp.where(empty, nt, -(-end // TILE))
    # offsets' unions can overlap at tile granularity (adjacent cell shifts
    # are smaller than a block's key span); merge into DISJOINT intervals so
    # every window is evaluated exactly once per block — the probe box
    # contains the L2 ball, so d^2 < radius alone then gives exact,
    # duplicate-free match sets.
    t0s, t1s = jax.lax.sort((t0, t1), dimension=1, num_keys=1)
    emax = jax.lax.associative_scan(jnp.maximum, t1s, axis=1)
    prev_end = jnp.concatenate(
        [jnp.zeros((G, 1), jnp.int32), emax[:, :-1]], axis=1
    )
    m_start = jnp.maximum(t0s, prev_end)
    tcnt = jnp.clip(t1s - m_start, 0)
    m_start = jnp.clip(m_start, 0, max(nt - 1, 0))
    cums = jnp.concatenate(
        [jnp.zeros((G, 1), jnp.int32),
         jnp.cumsum(tcnt, axis=1).astype(jnp.int32)], axis=1,
    )  # [G, NO+1]
    blockmeta = jnp.concatenate(
        [m_start.astype(jnp.int32), cums], axis=1
    )  # [G, 2*NO+1]
    m_meta, m_d2, cnt, wrote = sweep_search(
        qr_s, blockmeta, tiles, meta,
        radius=radius, K=K, TILE=TILE, dim=dim, block=block, impl=impl,
    )
    iperm = iperm[:Q0]
    return (
        jnp.take(m_meta, iperm, axis=0),
        jnp.take(m_d2, iperm, axis=0),
        jnp.take(cnt, iperm),
        jnp.take(wrote, iperm),
    )


def brute_matches(seeds: np.ndarray, windows: np.ndarray, radius: float):
    """Test oracle: exact per-seed match sets {window} with d^2 < radius."""
    out = []
    for q in seeds:
        d2 = ((windows - q[None, :]) ** 2).sum(axis=1)
        out.append(set(np.nonzero(d2 < radius)[0].tolist()))
    return out
