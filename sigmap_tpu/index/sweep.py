"""Sweep-index: the streaming search layout for the turbo engine.

Instead of answering each seed query with row gathers into a hash or
tree, the turbo engine inverts the loop: index windows are sorted by a
coarse grid cell key and stored PRE-TILED so the search
(ops/sweep_kernel.py) STREAMS contiguous window tiles past blocks of
key-sorted seeds, evaluating exact f32 squared distances densely (strict
d^2 < radius: nanoflann parity, nanoflann.hpp:249; same match set as the
reference's k-d tree radius search, spatial_index.cc:366).

Grid geometry (v2, measured on the 12 Mb synthetic workload):

* **PCA rotation.** Raw window dims are highly correlated (consecutive
  z-scored levels; eigenvalue spectrum ~[3.4, 1.6, 0.5, 0.2, ...]), so
  axis-aligned buckets discriminate poorly: a radius-0.08 ball's bounding
  box over the leading 4 raw dims contained ~535k candidate windows/seed.
  Windows are therefore stored in PCA-ROTATED coordinates
  w' = R^T (w - mu) (R orthonormal, from the window covariance): rotation
  is an isometry, so d^2(q', w') == d^2(q, w) exactly in real arithmetic
  (f32 rounding adds a ~1e-5-relative boundary band, same class as any
  accumulation-order difference vs nanoflann), while the leading rotated
  dims carry most of the variance — the same 4-dim bucket box shrinks to
  ~80k candidates/seed (6.7x).
* **span-3 cells** (cell width = sqrt(radius)): the L2 ball straddles
  <= 3 cells per dim; probes enumerate 3^(bd-1) offsets over the leading
  bd-1 dims with the last bucketed dim's span folded into each offset's
  contiguous range.  Finer cells beat span-2 (2*sqrt(r)) 2.8x on
  candidate volume in the rotated space.
* **mixed radix**: each bucketed dim gets its own radix sized to the
  rotated data's extent, keeping the dense cumulative cell table small
  (~1M cells at 12 Mb) so 2 array lookups replace hash probing.
* windows are tiled [T, 8, TILE] f32 ("transposed" per tile) so each
  coordinate row of a tile is one contiguous load, plus [T, TILE] i32
  packed metadata (group << 25 | target_position).

Reference parity: the window SET (masking sigmap.cc:19-185, dedup
spatial_index.cc:43-46, straddling windows sigmap_adaptor.h:89-97) is
identical to SignalIndex; only the storage order/basis differs, and
radius matches are order-insensitive (the reference searches with
sorted=false, spatial_index.cc:323-324).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .build import SignalIndex

# Number of bucketed (leading rotated) dims.  Measured: more dims sharpen
# per-seed boxes but widen per-block probe unions; 4 is the sweet spot for
# 6-dim indexes at span 3.
SWEEP_DIMS = 4
# Cells per dim a radius ball may straddle (span); cell width is
# 2*sqrt(radius)/(span-1).  span=3 -> width sqrt(radius).
SWEEP_SPAN = 3

PAD_COORD = 1.0e30  # padding coordinate: d^2 is huge for every seed
META_POS_BITS = 25  # packed meta: (group << 25) | target_position


def bucket_dims(dim: int) -> int:
    """Number of bucketed key dims for an index of dimension `dim`."""
    return min(SWEEP_DIMS, dim)


@dataclass
class SweepIndex:
    """Pre-tiled, cell-sorted window store + dense cumulative cell table.

    All window coordinates (tiles rows 0..dim-1) are in the PCA-rotated,
    mean-centered basis; queries must be rotated with `rot`/`mu` before
    key computation and distance evaluation (sweep_search does this).
    """

    tiles: np.ndarray      # [T, 8, TILE] f32 ROTATED coords (pad:
                           # PAD_COORD)
    meta: np.ndarray       # [T, TILE] i32 (group << 25) | tpos
    cum: np.ndarray        # [prod(radixes)+1] i32 cumulative windows/cell
    rot: np.ndarray        # [dim, dim] f32 orthonormal rotation (columns =
                           # principal dirs, descending variance)
    mu: np.ndarray         # [dim] f32 window mean (rotation center)
    origin: np.ndarray     # [bd] f32 grid origin in rotated coords
    radixes: tuple         # per-dim cell counts (len bd)
    span: int
    n_windows: int
    tile: int
    dim: int
    cell_width: float
    radius: float

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def bd(self) -> int:
        return len(self.radixes)

    def save(self, path: str) -> None:
        """Persist to an npz (the sweep analogue of SignalIndex.save; the
        reference persists its search structure as .pt/.si,
        spatial_index.cc:105-130)."""
        arrs = dict(
            tiles=self.tiles, meta=self.meta, cum=self.cum, rot=self.rot,
            mu=self.mu, origin=self.origin,
            radixes=np.asarray(self.radixes, np.int64),
            scalars=np.asarray(
                [self.span, self.n_windows, self.tile, self.dim], np.int64
            ),
            fscalars=np.asarray([self.cell_width, self.radius], np.float64),
        )
        f = open(path, "wb") if not hasattr(path, "write") else path
        np.savez(f, **arrs)
        if f is not path:
            f.close()

    @staticmethod
    def load(path: str) -> "SweepIndex":
        z = np.load(path)
        sc = z["scalars"]
        fs = z["fscalars"]
        return SweepIndex(
            tiles=z["tiles"], meta=z["meta"],
            cum=z["cum"], rot=z["rot"],
            mu=z["mu"], origin=z["origin"],
            radixes=tuple(int(x) for x in z["radixes"]),
            span=int(sc[0]), n_windows=int(sc[1]), tile=int(sc[2]),
            dim=int(sc[3]), cell_width=float(fs[0]), radius=float(fs[1]),
        )

    @staticmethod
    def build_cached(idx: SignalIndex, radius: float, tile: int = 1024,
                     span: int = SWEEP_SPAN,
                     cache_dir: str | None = None) -> "SweepIndex":
        """build() with an optional on-disk cache.

        The key hashes the index's window stream (cheap strided sample +
        shape) and the grid parameters, so repeated runs on the same index
        (bench re-runs, warm-cache subprocesses) skip the ~15 s rebuild."""
        if not cache_dir:
            return SweepIndex.build(idx, radius, tile=tile, span=span)
        import hashlib
        import os

        v = idx.values
        probe = v[:: max(1, len(v) // 65536)].tobytes()
        h = hashlib.sha1()
        h.update(probe)
        h.update(np.asarray(
            [idx.n_windows, idx.dim, tile, span],
            np.int64).tobytes())
        h.update(np.float64(radius).tobytes())
        path = os.path.join(cache_dir, f"sweep_{h.hexdigest()[:16]}.npz")
        if os.path.exists(path):
            try:
                return SweepIndex.load(path)
            except Exception:  # noqa: BLE001 - corrupt cache: rebuild
                pass
        sw = SweepIndex.build(idx, radius, tile=tile, span=span)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        sw.save(tmp)
        os.replace(tmp, path)
        return sw

    @staticmethod
    def build(idx: SignalIndex, radius: float, tile: int = 1024,
              span: int = SWEEP_SPAN) -> "SweepIndex":
        """Re-sort a SignalIndex's windows by the rotated sweep grid."""
        nw = idx.n_windows
        dim = idx.dim
        if dim < 2:
            raise ValueError("sweep layout needs index dim >= 2")
        if dim > 8:
            raise ValueError("sweep layout packs windows into 8 f32 rows")
        bd = bucket_dims(dim)
        w = 2.0 * float(np.sqrt(radius)) / (span - 1)
        if idx.win_group is None:
            idx.derive_window_metadata()
        if len(idx.ref_names) * 2 > (1 << (31 - META_POS_BITS)):
            raise ValueError("too many reference sequences for packed meta")
        if nw and int(idx.win_pos.max(initial=0)) >= (1 << META_POS_BITS):
            raise ValueError(
                "target positions overflow packed meta "
                f"(>= 2^{META_POS_BITS}); shard the index first"
            )
        # windows as [nw, dim] strided view over the flat value array
        Wview = np.lib.stride_tricks.sliding_window_view(
            idx.values, dim
        )[:nw]
        # PCA basis from a SAMPLE in f64 (covariance is 6x6; eigh exact);
        # the full-array rotation then runs in f32 accumulated from dim
        # shifted views — no [nw, dim] f64 materialization (the f64 copy +
        # matmul dominated index-load time at 12 Mb: ~35 s on this host)
        samp = Wview[:: max(1, nw // 300_000)].astype(np.float64)
        mu = samp.mean(axis=0) if len(samp) else np.zeros(dim)
        if len(samp) > dim:
            cov = np.cov((samp - mu).T)
            evals, evecs = np.linalg.eigh(np.atleast_2d(cov))
            order = np.argsort(evals)[::-1]
            rot = evecs[:, order]
        else:
            rot = np.eye(dim)
        rot_f = rot.astype(np.float32)
        vals = idx.values.astype(np.float32, copy=False)
        WR = np.empty((nw, dim), np.float32)               # [nw, dim]
        WR[:] = -(mu @ rot).astype(np.float32)[None, :]
        for d in range(dim):
            WR += vals[d : d + nw, None] * rot_f[d][None, :]
        origin = (
            WR[:, :bd].min(axis=0) if nw else np.zeros(bd, np.float32)
        )
        radixes = tuple(
            int(x) for x in (
                np.ceil(
                    ((WR[:, :bd].max(axis=0) - origin) / w)
                ).astype(np.int64) + 2
                if nw else np.full(bd, 2, np.int64)
            )
        )
        keyspace = int(np.prod(radixes))
        if keyspace > (1 << 27):
            raise ValueError(f"sweep cell table too large ({keyspace})")
        coords = np.clip(
            np.floor((WR[:, :bd] - origin) / w).astype(np.int64),
            0, np.asarray(radixes, np.int64)[None, :] - 1,
        )
        key = coords[:, 0].copy() if nw else np.zeros(0, np.int64)
        for d in range(1, bd):
            key = key * radixes[d] + coords[:, d]
        perm = np.argsort(key, kind="stable").astype(np.int32)
        counts = np.bincount(key, minlength=keyspace)
        cum = np.zeros(keyspace + 1, np.int32)
        np.cumsum(counts, out=cum[1:])
        T = max(1, -(-nw // tile))
        meta_flat = (
            (idx.win_group[perm].astype(np.int32) << META_POS_BITS)
            | idx.win_pos[perm].astype(np.int32)
        )
        tiles = np.zeros((T * tile, 8), np.float32)
        tiles[:nw, :dim] = WR[perm]
        tiles[nw:, 0] = PAD_COORD
        meta = np.zeros(T * tile, np.int32)
        meta[:nw] = meta_flat
        return SweepIndex(
            tiles=np.ascontiguousarray(
                tiles.reshape(T, tile, 8).transpose(0, 2, 1)
            ),
            meta=meta.reshape(T, tile),
            cum=cum,
            rot=rot.astype(np.float32),
            mu=mu.astype(np.float32),
            origin=origin.astype(np.float32),
            radixes=radixes,
            span=span,
            n_windows=nw, tile=tile, dim=dim,
            cell_width=w, radius=float(radius),
        )
