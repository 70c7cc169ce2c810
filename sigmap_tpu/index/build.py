"""Reference signal index construction (host side).

Device-first replacement for Sigmap's index path (sigmap.cc:999-1046,
spatial_index.cc:33-130): instead of a nanoflann k-d tree, the point cloud
is organized for *dense batched* radius search on device:

* the masked, deduplicated point stream (identical semantics to the
  reference: high-frequency canonical k-mer masking sigmap.cc:19-185,
  consecutive-|delta|<=0.01 suppression spatial_index.cc:43-46, positive
  strands of all sequences then negative strands, windows straddling
  stream boundaries exactly like the flat nanoflann adaptor
  sigmap_adaptor.h:89-97);
* overlapping dim-windows of that stream are grid-bucketed on their leading
  `bucket_dims` coordinates with cell width 2*sqrt(search_radius), giving an
  exact cover of the L2 ball with 2^bucket_dims probes per query;
* windows are sorted by cell key so every cell is a contiguous range —
  device queries turn into searchsorted + contiguous gathers + one fused
  distance evaluation (see mapping/seeding.py).

All statistics (mean/SD for z-scoring) use float64 on host, mirroring the
reference's double accumulators (sigmap.cc:1131-1146).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import IndexConfig
from ..io.fasta import ReferenceSequence
from ..io.pore_model import PoreModel
from ..utils import rolling_kmer_codes
from .. import native


def revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of 2-bit packed k-mers (uint64)."""
    x = (~kmers.astype(np.uint64)) & np.uint64((1 << (2 * k)) - 1)
    # reverse 2-bit groups within 2k bits
    r = np.zeros_like(x)
    for i in range(k):
        r |= ((x >> np.uint64(2 * i)) & np.uint64(3)) << np.uint64(2 * (k - 1 - i))
    return r


def masked_positions(
    seqs: list[ReferenceSequence], k: int, frequency: float
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """High-frequency/ambiguous k-mer masks for both strands.

    Reference: Sigmap::GenerateMaskedPositions (sigmap.cc:19-185):
    * canonical (min of fwd/revcomp) k-mer histogram over the positive
      strand of every sequence, counting only windows whose k bases are all
      unambiguous;
    * a window *ending* at an ambiguous base is masked; other windows
      overlapping the ambiguous base are left unmasked (quirk preserved);
    * threshold: count/num_kmers > frequency.
    Mask index is the window start (end position + 1 - k).
    """
    size = 1 << (2 * k)
    hist = np.zeros(size, np.int64)
    num_kmers = 0

    def run_ok(codes: np.ndarray) -> np.ndarray:
        """True where the k-mer ending at p has k unambiguous bases."""
        invalid = codes >= 4
        pos = np.arange(len(codes))
        last_bad = np.maximum.accumulate(np.where(invalid, pos, -1))
        run = pos - last_bad
        return run >= k

    fwd_cache = []
    for s in seqs:
        kmers = rolling_kmer_codes(s.codes, k)  # ends at p = i + k - 1
        rc = revcomp_kmers(kmers, k)
        canon = np.minimum(kmers, rc)
        ok = run_ok(s.codes)[k - 1 :]
        fwd_cache.append((kmers, rc, canon, ok))
        sel = canon[ok]
        hist += np.bincount(sel.astype(np.int64), minlength=size)
        num_kmers += len(sel)

    thresh = frequency * num_kmers
    pos_masks, neg_masks = [], []
    for s, (kmers, rc, canon, ok) in zip(seqs, fwd_cache):
        m = np.zeros(len(canon), bool)
        m[ok] = hist[canon[ok].astype(np.int64)] > thresh
        # ambiguous base at end position p masks window p+1-k
        bad_end = (s.codes >= 4)[k - 1 :]
        m[bad_end] = True
        pos_masks.append(m)

        nk = rolling_kmer_codes(s.neg_codes, k)
        nrc = revcomp_kmers(nk, k)
        ncanon = np.minimum(nk, nrc)
        nok = run_ok(s.neg_codes)[k - 1 :]
        nm = np.zeros(len(ncanon), bool)
        nm[nok] = hist[ncanon[nok].astype(np.int64)] > thresh
        nbad = (s.neg_codes >= 4)[k - 1 :]
        nm[nbad] = True
        neg_masks.append(nm)
    return pos_masks, neg_masks


def zscore_f64(x: np.ndarray) -> np.ndarray:
    """float64 z-score, (n-1) variance (sigmap.cc:1131-1155)."""
    x64 = x.astype(np.float64)
    mean = x64.mean()
    sd = np.sqrt(((x64 - mean) ** 2).sum() / (len(x64) - 1))
    return ((x64 - mean) / sd).astype(np.float32)


def pack_position(signal_index: int, signal_position: np.ndarray,
                  strand: int) -> np.ndarray:
    """(signal_index << 33) | (signal_position << 1) | strand
    (spatial_index.cc:47-52)."""
    return (
        (np.uint64(signal_index) << np.uint64(33))
        | (signal_position.astype(np.uint64) << np.uint64(1))
        | np.uint64(strand)
    )


@dataclass
class SignalIndex:
    """The genome signal index: deduped point stream + window grid."""

    dim: int
    max_leaf: int
    bucket_dims: int
    cell_width: float
    values: np.ndarray        # f32[N] deduped point values
    positions: np.ndarray     # u64[N] packed (signal_idx, signal_pos, strand)
    perm: np.ndarray          # i32[Nw] sorted-window -> original window index
    cell_keys: np.ndarray     # i64[K] sorted unique occupied cell keys
    cell_starts: np.ndarray   # i64[K+1] CSR offsets into sorted windows
    ref_names: list[str]
    ref_lengths: list[int]
    # derived, not persisted
    win_group: np.ndarray = field(default=None)  # i32[Nw] signal*2+strand
    win_pos: np.ndarray = field(default=None)    # i32[Nw] target signal pos

    # radix 35 keeps 6-dim keys inside int32 (35^6 = 1.84e9 < 2^31) for
    # device-side searchsorted; coords clipped to [0, 34] cover z in
    # roughly [-4.8, +5.1] at the default cell width sqrt(0.08), with
    # outliers folded into the edge cells (exactness preserved: both
    # points and probes clip identically).
    CELL_OFFSET = 17
    CELL_RADIX = 35

    @property
    def n_points(self) -> int:
        return len(self.values)

    @property
    def n_windows(self) -> int:
        return max(0, len(self.values) - self.dim + 1)

    def derive_window_metadata(self) -> None:
        p = self.positions[: self.n_windows]
        sig_idx = (p >> np.uint64(33)).astype(np.int32)
        strand = (p & np.uint64(1)).astype(np.int32)
        self.win_pos = ((p >> np.uint64(1)) & np.uint64(0xFFFFFFFF)).astype(
            np.int64
        ).astype(np.int32)
        self.win_group = sig_idx * 2 + strand

    def windows_sorted(self, pad_to: int = 8) -> np.ndarray:
        """Materialize [Nw, pad_to] f32 window coordinates in sorted order.

        Built with per-dim contiguous gathers (vals[perm + d]) - gathering
        through a sliding-window view is ~3x slower at genome scale."""
        out = np.zeros((self.n_windows, pad_to), np.float32)
        perm = self.perm.astype(np.int64)
        for d in range(self.dim):
            out[:, d] = self.values[perm + d]
        return out

    def cell_key_of(self, coords: np.ndarray) -> np.ndarray:
        """[..., bucket_dims] cell coords -> mixed-radix int64 key."""
        key = np.zeros(coords.shape[:-1], np.int64)
        for d in range(self.bucket_dims):
            key = key * self.CELL_RADIX + coords[..., d]
        return key

    def save(self, prefix: str) -> None:
        np.savez(
            prefix + ".sidx",
            dim=self.dim, max_leaf=self.max_leaf,
            bucket_dims=self.bucket_dims, cell_width=self.cell_width,
            values=self.values, positions=self.positions, perm=self.perm,
            cell_keys=self.cell_keys, cell_starts=self.cell_starts,
            ref_names=np.array(self.ref_names),
            ref_lengths=np.array(self.ref_lengths, np.int64),
        )

    @staticmethod
    def load(prefix: str) -> "SignalIndex":
        path = prefix + ".sidx" if not prefix.endswith(".sidx") else prefix
        z = np.load(path + (".npz" if not path.endswith(".npz") else ""))
        idx = SignalIndex(
            dim=int(z["dim"]), max_leaf=int(z["max_leaf"]),
            bucket_dims=int(z["bucket_dims"]),
            cell_width=float(z["cell_width"]),
            values=z["values"], positions=z["positions"], perm=z["perm"],
            cell_keys=z["cell_keys"], cell_starts=z["cell_starts"],
            ref_names=[str(x) for x in z["ref_names"]],
            ref_lengths=[int(x) for x in z["ref_lengths"]],
        )
        idx.derive_window_metadata()
        return idx

    # ------------------------------------------------------------ .pt I/O --
    PT_DTYPE = np.dtype(
        {"names": ["position", "value"],
         "formats": [np.uint64, np.float32],
         "offsets": [0, 8], "itemsize": 16}
    )  # struct Point with padding (sigmap_adaptor.h:7-17, 16-byte stride)

    def save_pt(self, path: str) -> None:
        """Reference-compatible .pt point-cloud file (spatial_index.cc:105-123):
        int32 dim, int32 max_leaf, size_t count, Point[count]."""
        with open(path, "wb") as f:
            np.array([self.dim, self.max_leaf], np.int32).tofile(f)
            np.array([self.n_points], np.uint64).tofile(f)
            arr = np.zeros(self.n_points, self.PT_DTYPE)
            arr["position"] = self.positions
            arr["value"] = self.values
            arr.tofile(f)

    @staticmethod
    def load_pt(path: str, cfg: IndexConfig, search_radius: float,
                ref_names: list[str], ref_lengths: list[int]) -> "SignalIndex":
        """Import a reference .pt file and build the grid over it."""
        with open(path, "rb") as f:
            dim, max_leaf = np.fromfile(f, np.int32, 2)
            (count,) = np.fromfile(f, np.uint64, 1)
            arr = np.fromfile(f, SignalIndex.PT_DTYPE, int(count))
        return _finalize_index(
            arr["value"].astype(np.float32), arr["position"].copy(),
            int(dim), int(max_leaf), cfg, search_radius,
            ref_names, ref_lengths,
        )


def _finalize_index(
    values: np.ndarray, positions: np.ndarray, dim: int, max_leaf: int,
    cfg: IndexConfig, search_radius: float,
    ref_names: list[str], ref_lengths: list[int],
) -> SignalIndex:
    """Grid-bucket the window set and assemble a SignalIndex."""
    nw = max(0, len(values) - dim + 1)
    bd = min(cfg.bucket_dims, dim)
    if SignalIndex.CELL_RADIX ** bd > 2**31:
        raise ValueError(f"bucket_dims={bd} overflows int32 cell keys")
    cell_width = cfg.cell_width_factor * float(np.sqrt(search_radius))
    # one contiguous pass for per-position cell coords, then shifted
    # contiguous slices per dim (sliding-window views gather ~30x slower)
    coords_flat = np.clip(
        np.floor(values / cell_width).astype(np.int32)
        + SignalIndex.CELL_OFFSET,
        0, SignalIndex.CELL_RADIX - 1,
    )
    key = np.zeros(nw, np.int32)
    for d in range(bd):
        key *= SignalIndex.CELL_RADIX
        key += coords_flat[d : d + nw]
    perm = np.argsort(key, kind="stable").astype(np.int32)
    sorted_keys = key[perm]
    cell_keys, first = np.unique(sorted_keys, return_index=True)
    cell_starts = np.concatenate([first, [nw]]).astype(np.int32)
    idx = SignalIndex(
        dim=dim, max_leaf=max_leaf, bucket_dims=bd, cell_width=cell_width,
        values=values, positions=positions, perm=perm,
        cell_keys=cell_keys, cell_starts=cell_starts,
        ref_names=ref_names, ref_lengths=ref_lengths,
    )
    idx.derive_window_metadata()
    return idx


def build_index(
    seqs: list[ReferenceSequence],
    pore: PoreModel,
    cfg: IndexConfig = IndexConfig(),
    search_radius: float = 0.08,
    verbose: bool = True,
) -> SignalIndex:
    """Full index construction (reference: Sigmap::ConstructIndex
    sigmap.cc:999-1046).

    mask k-mer length = dim + pore.k - 1 (sigmap.cc:1014)."""
    import time

    t0 = time.time()
    for s in seqs:
        s.prepare_negative()
    k_mask = cfg.dimension + pore.k - 1
    nat = native.kmer_masks(
        [s.codes for s in seqs], [s.neg_codes for s in seqs],
        k_mask, cfg.mask_frequency,
    )
    if nat is not None:
        pos_masks, neg_masks = nat
    else:
        pos_masks, neg_masks = masked_positions(seqs, k_mask, cfg.mask_frequency)

    values_parts, pos_parts = [], []
    signals = []
    for s in seqs:
        signals.append(
            (zscore_f64(pore.expected_signal(s.codes)),
             zscore_f64(pore.expected_signal(s.neg_codes)))
        )
    prev_last = None
    for strand in (0, 1):  # 0 = positive pass first (spatial_index.cc:82-93)
        for si, s in enumerate(seqs):
            sig = signals[si][strand]
            mask = (pos_masks if strand == 0 else neg_masks)[si]
            n_win = len(sig) - cfg.dimension + 1
            if n_win <= 0:
                continue
            kept, prev_last = native.dedup(
                sig[:n_win], mask.astype(np.uint8), cfg.dedup_delta,
                prev_val=prev_last,
            )
            values_parts.append(sig[kept])
            pos_parts.append(pack_position(si, kept.astype(np.uint64), strand))
    values = (
        np.concatenate(values_parts) if values_parts else np.zeros(0, np.float32)
    )
    positions = (
        np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.uint64)
    )
    idx = _finalize_index(
        values, positions, cfg.dimension, cfg.max_leaf, cfg, search_radius,
        [s.name for s in seqs], [s.length for s in seqs],
    )
    if verbose:
        import sys

        print(
            f"Collected {idx.n_points} points "
            f"({idx.n_windows} windows, {len(idx.cell_keys)} cells) "
            f"in {time.time()-t0:.1f}s.",
            file=sys.stderr,
        )
    return idx
