"""Device radius search: the portable XLA replacement for nanoflann.

The reference answers each seed query with a k-d tree radius search
(spatial_index.cc:366, nanoflann traversal).  Pointer-chasing trees map
poorly to wide SIMD devices; instead the index (index/build.py)
grid-buckets the reference windows on their leading `bucket_dims`
coordinates and sorts them so each cell is a contiguous range.  A query then becomes:

  1. probe the <=3^bd cells overlapping the L2 ball's bounding box
     (cell width = sqrt(radius) by default, so <=3 cells per dim);
  2. turn the found (start, len) ranges into a flat candidate slot space
     via scatter+cumsum delta addressing (no per-slot binary search);
  3. stage-1: gather 16-byte rows (leading 4 dims, f32) and reject
     candidates whose partial squared distance already exceeds the radius
     (a true lower bound - exact, no margin needed);
  4. stage-2: gather full rows for survivors and apply the strict
     dist^2 < radius test (nanoflann parity, nanoflann.hpp:249);
  5. compact matches per tile.

Everything is static-shape: seeds are processed in fixed-size tiles with
fixed per-seed candidate budgets; overflows are counted and reported.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index.build import SignalIndex


@dataclass(frozen=True)
class SearchParams:
    radius: float = 0.08          # squared-L2 (sigmap.cc:1380)
    dim: int = 6
    bucket_dims: int = 6
    cell_width: float = 0.2828427  # sqrt(0.08)
    seeds_per_tile: int = 64
    cap_per_seed: int = 32768      # candidate budget per seed
    surv_per_tile: int = 262144    # stage-2 survivor budget per tile
    matches_per_tile: int = 32768  # compacted match budget per tile

    @property
    def probes(self) -> np.ndarray:
        """Static [P, bd] probe offset grid; per-dim span is
        ceil(2*delta/w)+1 cells."""
        delta = float(np.sqrt(self.radius))
        span = int(np.ceil(2 * delta / self.cell_width)) + 1
        return np.array(
            list(itertools.product(range(span), repeat=self.bucket_dims)),
            np.int32,
        )

    @property
    def cap_per_tile(self) -> int:
        return self.seeds_per_tile * self.cap_per_seed




@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "W4", "W8", "perm", "win_group", "win_pos", "cell_keys",
        "cell_starts",
    ],
    meta_fields=["n_windows", "params"],
)
@dataclass
class DeviceIndex:
    """Device-resident index arrays (a pytree; params/n_windows static)."""

    W4: jax.Array          # [Nw, 4] f32 leading dims (stage-1 rows)
    W8: jax.Array          # [Nw, 8] f32 full windows, zero-padded dims
    perm: jax.Array        # [Nw] i32 sorted-window -> original window idx
    win_group: jax.Array   # [Nw] i32 (by ORIGINAL window idx) signal*2+strand
    win_pos: jax.Array     # [Nw] i32 (by ORIGINAL window idx)
    cell_keys: jax.Array   # [K] i32 sorted occupied cell keys
    cell_starts: jax.Array  # [K+1] i32
    n_windows: int
    params: SearchParams

    @staticmethod
    def from_host(idx: SignalIndex, radius: float = 0.08,
                  **tile_kw) -> "DeviceIndex":
        W = idx.windows_sorted(pad_to=8)
        params = SearchParams(
            radius=radius, dim=idx.dim, bucket_dims=idx.bucket_dims,
            cell_width=idx.cell_width, **tile_kw,
        )
        if idx.win_group is None:
            idx.derive_window_metadata()
        return DeviceIndex(
            W4=jnp.asarray(W[:, :4]),
            W8=jnp.asarray(W),
            perm=jnp.asarray(idx.perm, jnp.int32),
            win_group=jnp.asarray(idx.win_group, jnp.int32),
            win_pos=jnp.asarray(idx.win_pos, jnp.int32),
            cell_keys=jnp.asarray(idx.cell_keys, jnp.int32),
            cell_starts=jnp.asarray(idx.cell_starts, jnp.int32),
            n_windows=idx.n_windows,
            params=params,
        )


def _probe_ranges(dev: DeviceIndex, q: jax.Array, q_valid: jax.Array):
    """[Qt, 8] queries -> per-(seed, probe) candidate ranges.

    Returns (starts [Qt,P], lens [Qt,P]) into the sorted window array.
    """
    p = dev.params
    bd = p.bucket_dims
    delta = np.float32(np.sqrt(p.radius))
    w = np.float32(p.cell_width)
    off = SignalIndex.CELL_OFFSET
    radix = SignalIndex.CELL_RADIX
    qb = q[:, :bd]
    lo = jnp.clip(
        jnp.floor((qb - delta) / w).astype(jnp.int32) + off, 0, radix - 1
    )
    hi = jnp.clip(
        jnp.floor((qb + delta) / w).astype(jnp.int32) + off, 0, radix - 1
    )
    probes = jnp.asarray(p.probes)                     # [P, bd]
    coords = lo[:, None, :] + probes[None, :, :]       # [Qt, P, bd]
    valid = jnp.all(coords <= hi[:, None, :], axis=-1) & q_valid[:, None]
    key = jnp.zeros(coords.shape[:2], jnp.int32)
    for d in range(bd):
        key = key * radix + coords[..., d]
    K = dev.cell_keys.shape[0]
    pos = jnp.clip(
        jnp.searchsorted(dev.cell_keys, key.reshape(-1)).reshape(key.shape),
        0, K - 1,
    )
    found = (dev.cell_keys[pos] == key) & valid
    starts = dev.cell_starts[pos]
    lens = jnp.where(found, dev.cell_starts[pos + 1] - starts, 0)
    return starts, lens


def _expand_slots(starts, lens, cap_total):
    """Flat ranges -> per-slot (candidate index, range id) via delta
    scatter + cumsum.  starts/lens flat [R]; slots [cap_total]."""
    rl = lens
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(rl).astype(jnp.int32)]
    )
    total = offs[-1]
    prev_end = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), (starts + rl)[:-1].astype(jnp.int32)]
    )
    corr = starts.astype(jnp.int32) - prev_end
    D = jnp.ones(cap_total, jnp.int32).at[offs[:-1]].add(corr, mode="drop")
    cand = jnp.cumsum(D) - 1
    rid_prev = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.arange(len(rl) - 1, dtype=jnp.int32) + 1]
    )
    # range id per slot: scatter rid jumps (r - r_prev at each range start)
    rid_delta = (
        jnp.arange(len(rl), dtype=jnp.int32)
        - jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.arange(len(rl) - 1, dtype=jnp.int32)]
        )
    )
    del rid_prev
    R = jnp.zeros(cap_total, jnp.int32).at[offs[:-1]].add(
        rid_delta, mode="drop"
    )
    rid = jnp.cumsum(R)
    slot_valid = jnp.arange(cap_total) < total
    return cand, rid, slot_valid, total


def _compact(values: tuple, mask: jax.Array, cap: int):
    """Stable-compact rows where mask into [cap] slots; returns
    (compacted tuple, count)."""
    idx = jnp.where(mask, jnp.cumsum(mask) - 1, cap)
    count = jnp.minimum(mask.sum(), cap).astype(jnp.int32)
    outs = []
    for v in values:
        o = jnp.zeros((cap + 1,) + v.shape[1:], v.dtype)
        outs.append(o.at[idx].set(v, mode="drop")[:cap])
    return tuple(outs), count


def search_tile(dev: DeviceIndex, q: jax.Array, q_valid: jax.Array):
    """Radius search for one tile of seeds_per_tile queries.

    Returns (m_sid [M], m_widx [M] original window idx, m_dist [M],
    n_matches, n_cand, overflow_flags).
    """
    p = dev.params
    starts, lens = _probe_ranges(dev, q, q_valid)      # [Qt, P]
    # per-seed candidate budget (reference caps *matches* at 5000/seed,
    # spatial_index.cc:290,371-372; we cap candidates upstream)
    row_cum = jnp.cumsum(lens, axis=1)
    allowed = jnp.clip(p.cap_per_seed - (row_cum - lens), 0, None)
    seed_overflow = jnp.any(lens > allowed)
    lens = jnp.minimum(lens, allowed)
    n_cand = lens.sum()

    cand, rid, slot_valid, _ = _expand_slots(
        starts.reshape(-1), lens.reshape(-1), p.cap_per_tile
    )
    sid = rid // p.probes.shape[0]
    cand = jnp.where(slot_valid, cand, 0)

    # stage 1: partial distance on leading 4 dims (exact lower bound)
    r1 = dev.W4[cand]                                   # [cap, 4]
    q1 = q[:, :4][sid]
    d1 = jnp.sum((r1 - q1) ** 2, axis=-1)
    pass1 = slot_valid & (d1 < p.radius)

    (s_cand, s_sid), n_surv = _compact((cand, sid), pass1, p.surv_per_tile)
    surv_overflow = pass1.sum() > p.surv_per_tile
    surv_valid = jnp.arange(p.surv_per_tile) < n_surv

    # stage 2: full distance, strict < radius (nanoflann.hpp:249)
    r2 = dev.W8[s_cand]                                 # [S, 8]
    q2 = q[s_sid]
    d2 = jnp.sum((r2 - q2) ** 2, axis=-1)
    match = surv_valid & (d2 < p.radius)

    (m_sid, m_widx, m_dist), n_matches = _compact(
        (s_sid, dev.perm[s_cand], d2), match, p.matches_per_tile
    )
    match_overflow = match.sum() > p.matches_per_tile
    return (
        m_sid, m_widx, m_dist, n_matches, n_cand,
        jnp.stack([seed_overflow, surv_overflow, match_overflow]),
    )


@partial(jax.jit, static_argnames=("n_tiles",))
def search_flat(dev: DeviceIndex, seeds: jax.Array, seeds_valid: jax.Array,
                n_tiles: int):
    """Radius search over a flat, padded seed array [n_tiles*Qt, 8].

    Returns (sid [M], widx [M], dist [M], total, n_cand, ovf) with matches
    compacted ON DEVICE to the front of flat arrays — the host should
    transfer only [:total], not the padded per-tile buffers.
    """
    p = dev.params
    qt = p.seeds_per_tile
    seeds = seeds.reshape(n_tiles, qt, seeds.shape[-1])
    valid = seeds_valid.reshape(n_tiles, qt)

    def one(args):
        q, v = args
        return search_tile(dev, q, v)

    m_sid, m_widx, m_dist, nm, nc, ovf = jax.lax.map(one, (seeds, valid))
    M = p.matches_per_tile
    gsid = (
        m_sid + jnp.arange(n_tiles, dtype=jnp.int32)[:, None] * qt
    ).reshape(-1)
    mask = (jnp.arange(M)[None, :] < nm[:, None]).reshape(-1)
    (f_sid, f_widx, f_dist), total = _compact(
        (gsid, m_widx.reshape(-1), m_dist.reshape(-1)), mask, n_tiles * M
    )
    return f_sid, f_widx, f_dist, total, nc.sum(), ovf.any(axis=0)


def flatten_matches(out, params: SearchParams):
    """Host-side decode: transfer only the live match prefix."""
    f_sid, f_widx, f_dist, total, nc, ovf = out
    k = int(total)
    # power-of-two transfer size to bound eager-slice recompiles
    kb = min(f_sid.shape[0], 1 << max(k - 1, 0).bit_length()) if k else 1
    sids = np.asarray(jax.lax.slice_in_dim(f_sid, 0, kb))[:k]
    widx = np.asarray(jax.lax.slice_in_dim(f_widx, 0, kb))[:k]
    dist = np.asarray(jax.lax.slice_in_dim(f_dist, 0, kb))[:k]
    return sids, widx, dist, int(nc), np.asarray(ovf)


@jax.jit
def seed_candidate_counts(dev: DeviceIndex, seeds: jax.Array,
                          valid: jax.Array):
    """Per-seed candidate totals from the probe pass only (cheap)."""
    starts, lens = _probe_ranges(dev, seeds, valid)
    return lens.sum(axis=1)


def autotune_params(dev: DeviceIndex, n_sample: int = 512,
                    noise: float = 0.12, seed: int = 0,
                    max_cap: int = 65536) -> SearchParams:
    """Size the per-seed candidate budget from the index itself.

    Sample queries = index windows + event-level noise (what real seed
    windows look like); cap_per_seed = ~p99 of their probe candidate
    totals, so tile slot work tracks the actual workload instead of a
    worst-case constant.
    """
    import dataclasses

    rng = np.random.default_rng(seed)
    p = dev.params
    W = np.asarray(dev.W8[:: max(1, dev.n_windows // n_sample)][:n_sample])
    q = W + np.concatenate(
        [rng.normal(0, noise, (len(W), p.dim)).astype(np.float32),
         np.zeros((len(W), 8 - p.dim), np.float32)], axis=1,
    )
    qt = p.seeds_per_tile
    pad = (-len(q)) % qt
    if pad:
        q = np.concatenate([q, np.zeros((pad, 8), np.float32)])
    counts = np.asarray(
        seed_candidate_counts(
            dev, jnp.asarray(q),
            jnp.asarray(np.arange(len(q)) < n_sample),
        )
    )[:n_sample]
    p99 = float(np.percentile(counts, 99)) if len(counts) else 1024.0
    cap = 1 << int(np.ceil(np.log2(max(256.0, min(p99 * 1.5, max_cap)))))
    surv = min(max(qt * cap // 8, 16384), 262144)
    return dataclasses.replace(p, cap_per_seed=cap, surv_per_tile=surv)


def pad_seeds(windows: np.ndarray, params: SearchParams):
    """Pad a [Q, 8] seed array up to a whole number of tiles."""
    qt = params.seeds_per_tile
    n = len(windows)
    n_tiles = max(1, -(-n // qt))
    out = np.zeros((n_tiles * qt, windows.shape[1]), np.float32)
    out[:n] = windows
    valid = np.zeros(n_tiles * qt, bool)
    valid[:n] = True
    return out, valid, n_tiles
