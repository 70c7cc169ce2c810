"""Turbo engine: device-resident streaming mapping rounds.

The production streaming driver (the exact host path lives in
mapping/driver.py; two earlier device engines it superseded were deleted).
Replaces Sigmap::StreamingMap's per-read OpenMP taskloop
(/root/reference/src/sigmap.cc:549-880) with batched device rounds that
keep host<->device traffic and host round-trips to a minimum:

* all ACTIVE reads in a batch advance their chunk index in lockstep, so
  round r needs exactly chunk slice r of the batch: a prefetch thread
  quantizes, uploads and event-detects the NEXT batch (all its chunks in
  one device call) while the device runs this batch's rounds;
* the search is the streaming merge-join sweep (ops/sweep_kernel.py):
  cell-sorted window tiles streamed contiguously past key-sorted seed
  blocks, exact d^2 < radius — no per-seed tree walks, no giant sorts;
* anchors flow straight from the sweep's [B, S, K] slots into chaining in
  qpos-major [A, B] layout — a transpose, NOT the [B, 8192] scatter +
  5-key sort the fast path pays (qpos-major is a valid chaining
  topological order: predecessors need qdiff > 0, spatial_index.cc:511);
* chaining + chain selection + carry-out run in one fused pass
  (ops/chain_fused.py) whose ring band replaces the reference's
  5000-predecessor band and whose inherited chain state replaces
  traceback (spatial_index.cc:165-220);
* early-stop rules (sigmap.cc:667-688) are evaluated ON DEVICE; the host
  sees only a [B] done vector per round, so the whole multi-chunk loop
  costs one tiny download per round.

Semantic divergences from the exact path: ring-band chaining (RING
anchors) instead of the full 5000 band; THREE-chain selection with the
reference's primary-chain candidacy gates (min score, score > max/2,
the /3 break — spatial_index.cc:230-247,545-546) instead of traceback
enumeration; carry-forward keeps the chain frontier (last RING anchor
states) rather than all member anchors of the best chains; per-seed
matches cap at the K CLOSEST by d^2 (reference: first 5000 in tree
order, spatial_index.cc:290), with per-read overflow tracked and
unmapped+overflow reads re-mapped by the exact engine (rescue); emitted
query bounds/tag statistics are reconstructed from the best chain's
inherited state.  Concordance vs the exact path is measured in
tests/test_turbo.py and reported in PARITY.md / PARITY_TURBO.json.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChainingConfig, EventDetectorConfig, MappingConfig, SigmapConfig
from ..index.build import SignalIndex
from ..index.sweep import META_POS_BITS, SweepIndex
from ..io.paf import ChainsSummary, PAFRecord, streaming_tags
from ..io.signals import ReadSignal
from ..signal.events import batch_generate_features
from .sweep_search import SEED_PAD, sweep_round

NEG = np.float32(-1e30)


@dataclass(frozen=True)
class TurboParams:
    """Static shapes of the turbo round (compile-time constants)."""

    # K and RING trade against each other: the ring band must SPAN many
    # seeds (RING/K seeds' worth of anchors) or chains fragment between
    # consecutive true-locus anchors.  The sweep keeps each seed's K
    # CLOSEST matches, in (d^2, meta) order.  Recall at 12 Mb / B=2048
    # with rescue off:
    # (K=8, RING=256) maps 79% of reads, (K=8, RING=768) maps 99.4%,
    # (K=16, RING=768) 99.76%.  A smaller seed block shrinks the block
    # union each seed is evaluated against.
    S: int = 256          # seed slots per read per chunk
    K: int = 8            # match slots per seed (reference cap: 5000)
    RING: int = 768       # chaining band / carry size
    TILE: int = 1024      # sweep tile width
    max_events: int = 1024
    max_features: int = 1024
    block: int = 32       # sweep seed-block (a power of two)
    # per-layer implementation overrides, e.g. (("sweep", "plain"),);
    # layers not named take ops/impl.py's default for the backend
    impls: tuple = ()
    # Capacity policy: per-read overflow (matches past K or seeds past S)
    # is tracked on device; reads that finish UNMAPPED with overflow are
    # re-mapped through the exact host engine (native k-d tree + full
    # reference chaining, the 5000-anchor cap of spatial_index.cc:290) on
    # a thread pool overlapping device rounds — so K/S truncation can
    # never silently unmap a read the reference would map.
    rescue: bool = True


def build_seeds(feats, counts, offsets, S: int, step: int, dim: int,
                min_feature_length: int):
    """Feature rows -> padded seed windows.

    Returns (seeds [B, S, 8] f32 with SEED_PAD fill, qpos [B, S] i32,
    has_f [B] bool, seed_ovf scalar bool)."""
    B, F = feats.shape
    has_f = counts > min_feature_length
    n_seeds = jnp.where(
        has_f, jnp.clip((counts - dim) // step, 0, S), 0
    ).astype(jnp.int32)
    j = jnp.arange(S, dtype=jnp.int32)
    positions = (j + 1) * step                                    # [S]
    # window element (s, c) = feats[(s+1)*step + c]: STATIC indices, so the
    # gather is 8 strided slices (the take_along_axis form lowered to a slow
    # row gather — ~100 ms/round at B=512)
    need = (S + 1) * step + 8
    fp = jnp.pad(feats, ((0, 0), (0, max(0, need - F)))) if need > F else feats
    wins = jnp.stack(
        [
            jax.lax.slice(fp, (0, step + c), (B, step + c + step * S),
                          (1, step))
            for c in range(8)
        ],
        axis=2,
    ) * (jnp.arange(8) < dim)[None, None, :]                      # [B, S, 8]
    seed_ok = j[None, :] < n_seeds[:, None]                       # [B, S]
    pad_row = jnp.where(jnp.arange(8) < dim, np.float32(SEED_PAD), 0.0)
    seeds = jnp.where(seed_ok[:, :, None], wins, pad_row[None, None, :])
    seed_ovf = jnp.any(
        jnp.where(has_f, (counts - dim) // step, 0) > S
    )
    qpos = positions[None, :] + offsets[:, None]                  # [B, S]
    return seeds, qpos, has_f, seed_ovf


def anchors_qpos_major(m_meta, m_d2, wrote, qpos, B: int, S: int, K: int):
    """Sweep outputs -> chaining inputs in qpos-major [S*K, B] layout."""
    m_meta = m_meta.reshape(B, S, K)
    m_d2 = m_d2.reshape(B, S, K)
    wrote = wrote.reshape(B, S)
    kk = jnp.arange(K, dtype=jnp.int32)
    a_valid = kk[None, None, :] < wrote[:, :, None]               # [B, S, K]
    POS_MASK = (1 << META_POS_BITS) - 1
    # [B, S, K] -> [S*K, B] as ONE 2-D transpose of [B, S*K] (identical
    # element mapping to transpose(1, 2, 0); the 3-D form lowered to a
    # ~100 ms gather at B=512)
    n_t = (m_meta & POS_MASK).reshape(B, S * K).T
    n_g = jnp.where(a_valid, m_meta >> META_POS_BITS, -1)
    n_g = n_g.reshape(B, S * K).T
    n_d = m_d2.reshape(B, S * K).T
    n_q = jnp.broadcast_to(
        qpos[:, :, None], (B, S, K)
    ).reshape(B, S * K).T
    return n_t, n_q, n_d, n_g


def turbo_round_body(
    tiles, meta, cum, rot, mu, origin, feats, counts_r, n_full,
    chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
    p: TurboParams, step: int, radius: float, dim: int,
    geom: tuple,
    chain_cfg: ChainingConfig,
    m: MappingConfig, merge_matches=None,
):
    """One streaming round (traceable body shared by the single-chip jit
    and the shard_map multi-chip path).

    feats/counts_r are THIS round's chunk-feature slice ([B, F] / [B]),
    cut from the batch's precomputed [B, NC, F] tensor by the driver
    (slice_chunk) so the round's compiled shapes are NC-independent: one
    turbo_round compile serves every chunk-count bucket.  All active
    reads advance in lockstep, so round r consumes chunk slice r; rows of
    inactive reads are ignored via the active mask.

    merge_matches: optional callable (m_meta [Q,K], m_d2, cnt, wrote) ->
    same shapes, merging per-index-shard results across a mesh axis."""
    B = feats.shape[0]
    S, K = p.S, p.K

    active = ~done & (chunk_idx < n_full) & (chunk_idx < m.max_num_chunks)

    # ---- 1. this round's precomputed chunk features ----------------------
    counts = jnp.where(active, counts_r, 0)
    has_f = counts > m.min_feature_length

    # ---- 2. seed windows ------------------------------------------------
    seeds, qpos, has_f, seed_ovf = build_seeds(
        feats, counts, offsets, S, step, dim, m.min_feature_length
    )

    # ---- 3. sweep radius search ------------------------------------------
    radixes, span, cell_width = geom
    m_meta, m_d2, cnt, wrote = sweep_round(
        seeds.reshape(B * S, 8), cum, tiles, meta, rot, mu, origin,
        radius=radius, K=K, TILE=p.TILE, dim=dim, block=p.block,
        radixes=radixes, span=span, cell_width=cell_width,
        impl=dict(p.impls).get("sweep"),
    )
    if merge_matches is not None:
        m_meta, m_d2, cnt, wrote = merge_matches(m_meta, m_d2, cnt, wrote)
    match_ovf = jnp.any(cnt > K)

    # ---- 4. anchors in qpos-major [A, B] layout --------------------------
    n_t, n_q, n_d, n_g = anchors_qpos_major(
        m_meta, m_d2, wrote, qpos, B, S, K
    )

    # carried anchors occupy rows 0..RING-1
    c_t, c_q, c_g, c_score, c_stt, c_stq, c_n, c_sumd = carry
    a_t = jnp.concatenate([c_t, n_t], axis=0)
    a_q = jnp.concatenate([c_q, n_q], axis=0)
    a_d = jnp.concatenate([jnp.zeros((p.RING, B), jnp.float32), n_d], axis=0)
    a_g = jnp.concatenate([jnp.where(c_g == -2, -1, c_g), n_g], axis=0)

    # ---- 5. fused chaining + selection + carry ---------------------------
    from ..ops.chain_fused import chain_fused

    sum_f, sum_i, new_carry = chain_fused(
        a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd,
        radius=radius, dim=dim, ring=p.RING, cfg=chain_cfg, kb=K,
        impl=dict(p.impls).get("chain"),
    )
    s1 = sum_f[0]
    s2_raw = sum_f[1]
    s3_raw = sum_f[3]
    n1 = sum_i[5]
    # chain candidacy gates matching the reference's selection pipeline:
    # an end anchor only becomes a chain if score >= min_chaining_score
    # AND score > max/2 (spatial_index.cc:545-546); chain 1 itself needs
    # s1 >= min_chaining_score or the read has NO chains at all.  (The /3
    # primary break, spatial_index.cc:230-231, is implied: x > s1/2 >
    # s1/3.)  This is what makes nc match the reference's chains.size()
    # and mapq hit 60 when the runner-up is weak.
    min_sc = np.float32(chain_cfg.min_chaining_score)
    found = active & has_f & (s1 >= min_sc)
    has2 = found & (s2_raw >= min_sc) & (2.0 * s2_raw > s1)
    has3 = has2 & (s3_raw >= min_sc) & (2.0 * s3_raw > s1)
    s2 = jnp.where(has2, s2_raw, 0.0)
    s3 = jnp.where(has3, s3_raw, 0.0)
    nc = 1 + has2.astype(jnp.int32) + has3.astype(jnp.int32)

    # ---- 6. stop rules (sigmap.cc:667-688) --------------------------------
    sm = (s1 + s2 + s3) / nc.astype(jnp.float32)
    stop = (
        (has2 & (s1 / jnp.maximum(s2, 1e-30) >= m.stop_mapping_ratio))
        | (has2 & (s1 >= m.stop_mapping_mean_ratio * sm))
        | (found & ~has2 & (n1 >= m.stop_mapping_min_num_anchors))
    )

    # ---- 7. best-so-far summary ------------------------------------------
    upd = found & (s1 > rb_f[0])
    rb_f = jnp.where(upd[None, :], sum_f[:4], rb_f)
    rb_i_new = jnp.concatenate(
        [sum_i[:6], nc[None, :], rb_i[7:8]], axis=0
    )
    rb_i = jnp.where(upd[None, :], rb_i_new, rb_i)
    # row 7 accumulates PER-READ capacity overflow (per-seed matches past
    # K, or seed positions past S): the driver routes unmapped+overflow
    # reads through the exact engine (rescue), so the reference's 5000
    # cap (spatial_index.cc:290) is never silently under-delivered
    ovf_read = active & (
        (cnt.reshape(B, S) > K).any(axis=1)
        | (jnp.where(has_f, (counts - dim) // step, 0) > S)
    )
    rb_i = rb_i.at[7].set(rb_i[7] | ovf_read.astype(jnp.int32))

    new_offsets = offsets + jnp.where(active & has_f, counts, 0)
    exhausted = active & (
        (chunk_idx + 1 >= n_full) | (chunk_idx + 1 >= m.max_num_chunks)
    )
    new_done = done | (~active) | stop | exhausted
    new_stopped = stopped | stop
    # the reference's stop `break` happens BEFORE the loop increment, so a
    # stopped read's chunk_index stays AT the stopping chunk
    # (sigmap.cc:647-689); incrementing stopped reads too made every
    # streamed ci: tag one chunk late vs the exact engine
    new_chunk_idx = chunk_idx + (active & ~stop).astype(jnp.int32)

    # carry survives across chunks only for still-running reads; for done
    # reads its content no longer matters (kept as-is)
    ovf = jnp.stack([match_ovf, seed_ovf])
    # single packed host signal: [done(B), ovf(2)] — the driver downloads
    # exactly one small array per round
    host_sig = jnp.concatenate(
        [new_done.astype(jnp.uint8), ovf.astype(jnp.uint8)]
    )
    return (
        new_chunk_idx, new_done, new_stopped, new_offsets, new_carry,
        rb_f, rb_i, counts, ovf, host_sig,
    )


@partial(
    jax.jit,
    static_argnames=("p", "step", "radius", "dim", "geom", "chain_cfg",
                     "m"),
)
def turbo_round(
    tiles: jax.Array,      # [T, 8, TILE] f32 sweep index (rotated coords)
    meta: jax.Array,       # [T, TILE] i32
    cum: jax.Array,        # [prod(radixes)+1] i32
    rot: jax.Array,        # [dim, dim] f32 PCA rotation (index/sweep.py)
    mu: jax.Array,         # [dim] f32 rotation center
    origin: jax.Array,     # [bd] f32 grid origin
    feats: jax.Array,      # [B, F] f32 THIS round's chunk features
    counts_r: jax.Array,   # [B] i32 THIS round's feature counts
    n_full: jax.Array,     # [B] i32 full chunks per read
    chunk_idx: jax.Array,  # [B] i32
    done: jax.Array,       # [B] bool
    stopped: jax.Array,    # [B] bool (stop rule fired)
    offsets: jax.Array,    # [B] i32 accumulated feature counts
    carry: tuple,          # 8 x [RING, B] (t, q, g, score, stt, stq, n, sumd)
    rb_f: jax.Array,       # [4, B] best-so-far f32 (s1, s2, sumd1, s3)
    rb_i: jax.Array,       # [8, B] best-so-far i32 (g1, tstart, tend,
                           #   qstart, qend, n1, nc, ovf)
    p: TurboParams,
    step: int,
    radius: float,
    dim: int,
    geom: tuple,           # (radixes, span, cell_width) — static
    chain_cfg: ChainingConfig,
    m: MappingConfig,
):
    return turbo_round_body(
        tiles, meta, cum, rot, mu, origin, feats, counts_r,
        n_full, chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
        p, step, radius, dim, geom, chain_cfg, m,
    )


@jax.jit
def slice_chunk(feats_all: jax.Array, counts_all: jax.Array, r):
    """Cut round r's [B, F]/[B] slice out of the precomputed [B, NC, F]
    feature tensor (the only NC-shaped compile in the round loop)."""
    return (
        jax.lax.dynamic_index_in_dim(feats_all, r, 1, keepdims=False),
        jax.lax.dynamic_index_in_dim(counts_all, r, 1, keepdims=False),
    )


@partial(
    jax.jit,
    static_argnames=("p", "ed_cfg", "compress_delta"),
)
def batch_features(
    q: jax.Array,       # [B, NC, Cs] uint16 quantized pA samples
    qoff: jax.Array,    # [B] f32 per-read dequant offset
    qscale: jax.Array,  # [B] f32 per-read dequant scale
    n_full: jax.Array,  # [B] i32 full chunks per read
    p: TurboParams,
    ed_cfg: EventDetectorConfig,
    compress_delta: float,
):
    """Event-detect + compress ALL of a batch's chunks in one call over
    its B*NC chunk rows.

    pa = (q + qoff) * qscale reproduces io.signals.dac_to_pa bit-for-bit
    when the read came from DAC samples (quantize_batch recovers the raw
    integers); rounds then just slice the [B, NC, F] feature tensor.
    Chunks past a read's n_full get clen 0 (they produce counts 0).
    Event work for chunks after a read early-stops is wasted by design:
    it runs once per batch, fully parallel over B*NC rows, and is far
    cheaper than the per-round sweep it used to serialize with."""
    B, NC, Cs = q.shape
    rows = B * NC
    chunk_ok = jnp.arange(NC)[None, :] < n_full[:, None]
    clen = jnp.where(chunk_ok, Cs, 0).astype(jnp.int32).reshape(rows)
    pa = (q.reshape(rows, Cs).astype(jnp.float32)
          + jnp.repeat(qoff, NC)[:, None]) * jnp.repeat(qscale, NC)[:, None]
    feats, counts = batch_generate_features(
        pa, clen, cfg=ed_cfg, max_events=p.max_events,
        max_features=p.max_features, compress_delta=compress_delta,
    )
    return (feats.reshape(B, NC, -1),
            counts.reshape(B, NC).astype(jnp.int32))


def quantize_batch(batch, B, NC, Cs, max_chunks, threads: int = 1):
    """Host-side transport quantization: pA f32 -> uint16 + per-read affine.

    When the read's pA stream is DAC-derived (pa = (raw + offset) * scale,
    io/signals.py dac_to_pa), the inverse recovers the exact raw integers
    and device dequantization is bit-identical to the host pA values.
    Otherwise a per-read min/max affine is used (error <= (max-min)/65000,
    ~65x below one DAC step).

    threads > 1 fans the per-read loop over a host thread pool (rows are
    disjoint) — the turbo-side consumer of the reference's -t flag
    (sigmap.cc:1340-1341)."""
    n_full = np.zeros(B, np.int32)
    q = np.zeros((B, NC, Cs), np.uint16)
    qoff = np.zeros(B, np.float32)
    qscale = np.ones(B, np.float32)
    if threads > 1 and len(batch) > 1:
        from concurrent.futures import ThreadPoolExecutor

        def work(lo_hi):
            lo, hi = lo_hi
            for j in range(lo, hi):
                _quantize_one(batch[j], j, q, qoff, qscale, n_full, NC, Cs,
                              max_chunks)

        n = len(batch)
        step = -(-n // threads)
        spans = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(work, spans))
        return q, qoff, qscale, n_full
    for i, s in enumerate(batch):
        _quantize_one(s, i, q, qoff, qscale, n_full, NC, Cs, max_chunks)
    return q, qoff, qscale, n_full


def _quantize_one(s, i, q, qoff, qscale, n_full, NC, Cs, max_chunks):
    n_full[i] = min(s.length // Cs, max_chunks)
    L = min(s.length, NC * Cs)
    pa = s.pa[:L].astype(np.float32)
    ku = None
    scale = np.float32(s.range / s.digitisation) if s.digitisation else 0
    off = np.float32(s.offset)
    if scale > 0 and L:
        k = np.rint(pa / scale - off)
        if 0 <= k.min(initial=0) and k.max(initial=0) <= 65535:
            cand = k.astype(np.uint16)
            if np.array_equal(
                (cand.astype(np.float32) + off) * scale, pa
            ):
                ku = cand
    if ku is None and L:
        lo = np.float32(pa.min())
        hi = np.float32(pa.max())
        scale = np.float32(max(hi - lo, 1e-6) / 65000.0)
        off = np.float32(lo / scale)
        ku = np.clip(np.rint(pa / scale - off), 0, 65535).astype(
            np.uint16
        )
    if L:
        q[i].reshape(-1)[:L] = ku
    qoff[i] = off
    qscale[i] = scale
    return q, qoff, qscale, n_full


class TurboMapper:
    """Streaming mapper driving turbo_round over a device-resident batch.

    Reads are processed in batches of runtime.read_batch.  Per batch:
    signals are transport-quantized to uint16 (quantize_batch), uploaded
    once, and event-detected for ALL chunks in one device call
    (batch_features) — all on a prefetch thread that overlaps the previous
    batch's rounds.  Rounds then advance every active read one chunk in
    lockstep, consuming precomputed feature slices; the only per-round
    host traffic is the packed [B+2] done/overflow download.
    """

    def __init__(self, index: SignalIndex, config: SigmapConfig = SigmapConfig(),
                 params: TurboParams | None = None):
        self.index = index
        self.cfg = config
        if index.win_group is None:
            index.derive_window_metadata()
        self.num_refs = len(index.ref_names)
        self.p = params = params or TurboParams()
        sw = SweepIndex.build_cached(
            index, config.mapping.search_radius, tile=params.TILE,
            cache_dir=config.runtime.sweep_cache_dir,
        )
        self.tiles = jax.device_put(sw.tiles)
        self.meta = jax.device_put(sw.meta)
        self.cum = jax.device_put(sw.cum)
        self.rot = jax.device_put(sw.rot)
        self.mu = jax.device_put(sw.mu)
        self.origin = jax.device_put(sw.origin)
        self.geom = (sw.radixes, sw.span, sw.cell_width)
        from concurrent.futures import ThreadPoolExecutor

        self._uploader = ThreadPoolExecutor(1)
        import threading

        self._oracle = None
        self._oracle_lock = threading.Lock()
        self._oracle_kicked = False
        self._rescue_pool = (
            ThreadPoolExecutor(max(1, config.runtime.num_threads))
            if self.p.rescue else None
        )
        self._rescue_futs: list = []
        self._ovf_warned = False

    def _get_oracle(self):
        with self._oracle_lock:
            if self._oracle is None:
                from ..oracle import Oracle

                self._oracle = Oracle(self.index, self.cfg)
        return self._oracle

    def _rescue_one(self, rid: int, s: ReadSignal, turbo_mt: float):
        t0 = time.perf_counter()
        oracle = self._get_oracle()
        chunk_idx_adj, num_events, chains, _stopped = oracle.streaming_read(
            s.pa
        )
        from .driver import streaming_record

        mt = turbo_mt + (time.perf_counter() - t0) * 1000
        return rid, streaming_record(
            self.index, self.cfg, rid, s.read_id, s.length, chunk_idx_adj,
            num_events, chains, mt,
        )

    def close(self):
        self._uploader.shutdown(wait=False)
        if self._rescue_pool is not None:
            self._rescue_pool.shutdown(wait=False)

    def __del__(self):  # noqa: D105 - release the uploader thread
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # cross-batch prefetch overlap; DISABLED in multi-process mode, where
    # the prefetch thread's global-jit dispatches (upload + batch_features)
    # would interleave nondeterministically with the main thread's round
    # dispatches — multi-process JAX requires every process to enqueue the
    # same global computations in the same order (observed: gloo size
    # mismatch crash in the 2-process scaling run)
    _overlap_batches = True

    def streaming_map(self, signals: list[ReadSignal]) -> list[PAFRecord]:
        records: dict[int, PAFRecord] = {}
        B = self.cfg.runtime.read_batch
        bases = list(range(0, len(signals), B))
        if not bases:
            return []
        if not self._overlap_batches:
            for base in bases:
                self._map_batch(signals[base : base + B], base, records)
            return self._drain_rescues(records, len(signals))
        # batch N+1's quantization + upload + event precompute ride the
        # uploader thread while batch N's rounds run (cross-batch overlap)
        fut = self._uploader.submit(
            self._prepare_batch, signals[bases[0] : bases[0] + B]
        )
        for bi, base in enumerate(bases):
            prep = fut.result()
            if bi + 1 < len(bases):
                nxt = bases[bi + 1]
                fut = self._uploader.submit(
                    self._prepare_batch, signals[nxt : nxt + B]
                )
            self._map_batch(signals[base : base + B], base, records, prep)
        return self._drain_rescues(records, len(signals))

    def _drain_rescues(self, records: dict, n: int) -> list[PAFRecord]:
        if self._rescue_futs:
            import sys

            n_remap = 0
            for fut in self._rescue_futs:
                rid, rec = fut.result()
                if rec.is_mapped:
                    n_remap += 1
                records[rid] = rec
            print(
                f"turbo: {len(self._rescue_futs)} capacity-overflow reads "
                f"re-mapped through the exact engine ({n_remap} mapped)",
                file=sys.stderr,
            )
            self._rescue_futs = []
        return [records[i] for i in range(n) if i in records]

    # ------------------------------------------------------------------ --

    def _prepare_batch(self, batch: list[ReadSignal]):
        """Quantize + upload + event-precompute one batch (thread-safe)."""
        import os
        t_prep0 = time.perf_counter()
        m = self.cfg.mapping
        B = self.cfg.runtime.read_batch
        Cs = m.chunk_size
        nc_raw = max(
            1,
            max(
                (min(s.length // Cs, m.max_num_chunks) for s in batch),
                default=1,
            ),
        )
        # bucket NC so every batch shape hits a cached compile (finer
        # than powers of two: chunks beyond every read's n_full are pure
        # wasted event compute)
        for NC in (1, 2, 3, 4, 6, 8, 12, 16, 24, 30):
            if NC >= nc_raw or NC >= m.max_num_chunks:
                break
        q, qoff, qscale, n_full = quantize_batch(
            batch, B, NC, Cs, m.max_num_chunks,
            threads=self.cfg.runtime.num_threads,
        )
        qd, qoff_d, qscale_d, n_full_d = self._place_batch(
            q, qoff, qscale, n_full
        )
        t_put = time.perf_counter()
        feats_all, counts_all = batch_features(
            qd, qoff_d, qscale_d, n_full_d,
            p=self.p, ed_cfg=self.cfg.event,
            compress_delta=m.compress_delta,
        )
        if os.environ.get("SIGMAP_TURBO_DEBUG"):
            import sys
            counts_all.block_until_ready()
            print(
                f"[turbo] prepare: quantize+put "
                f"{t_put - t_prep0:.2f}s events "
                f"{time.perf_counter() - t_put:.2f}s NC={NC}",
                file=sys.stderr, flush=True,
            )
        return feats_all, counts_all, n_full_d, n_full, NC

    def _map_batch(self, batch: list[ReadSignal], base: int, records: dict,
                   prep=None):
        m = self.cfg.mapping
        B = self.cfg.runtime.read_batch
        if prep is None:
            prep = self._prepare_batch(batch)
        feats_all, counts_all, n_full_d, n_full, NC = prep
        state = self._place_state(self._init_state(B))
        (chunk_idx, done, stopped, offsets, carry, rb_f, rb_i) = state

        mt = np.zeros(B)
        prev_done = n_full == 0
        done_h = prev_done.copy()
        rounds = 0
        while not done_h.all():
            t0 = time.perf_counter()
            feats_r, counts_r = self._slice_chunk(
                feats_all, counts_all, np.int32(rounds)
            )
            out = self._run_round(
                feats_r, counts_r, n_full_d,
                chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
            )
            (chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
             _counts, _ovf, host_sig) = out
            done_h, ovf_h = self._unpack_host_sig(
                self._fetch(host_sig), B
            )
            if ovf_h.any():
                if self._rescue_pool is not None and not self._oracle_kicked:
                    # overflow somewhere this batch: start building the
                    # exact-rescue oracle now so it overlaps device rounds
                    self._oracle_kicked = True
                    self._rescue_pool.submit(self._get_oracle)
                elif self._rescue_pool is None and not self._ovf_warned:
                    import sys

                    print(
                        "warning: turbo capacity overflow with rescue "
                        "DISABLED [match="
                        f"{bool(ovf_h[0])} seeds={bool(ovf_h[1])}]; raise "
                        "TurboParams.K / TurboParams.S or anchors are "
                        "dropped",
                        file=sys.stderr,
                    )
                    self._ovf_warned = True
            round_ms = (time.perf_counter() - t0) * 1000
            act = ~prev_done
            n_act = max(1, int(act.sum()))
            mt[act] += round_ms / n_act
            prev_done = done_h
            rounds += 1
            import os as _os
            if _os.environ.get("SIGMAP_TURBO_DEBUG"):
                import sys as _sys
                print(
                    f"[turbo] round {rounds - 1}: {round_ms:.0f} ms "
                    f"active {n_act}",
                    file=_sys.stderr, flush=True,
                )
        # final summaries to host
        rb_f_h = self._fetch(rb_f)
        rb_i_h = self._fetch(rb_i)
        chunk_idx_h = self._fetch(chunk_idx)
        stopped_h = self._fetch(stopped)
        offsets_h = self._fetch(offsets)
        for i, s in enumerate(batch):
            self._emit(
                records, base + i, s, rb_f_h[:, i], rb_i_h[:, i],
                int(chunk_idx_h[i]), bool(stopped_h[i]), int(offsets_h[i]),
                float(mt[i]), int(n_full[i]),
            )

    # --- placement/execution hooks (overridden by TurboShardMapper) -----

    # device -> host transfer; multi-process mappers override with a
    # process_allgather so data-sharded rows reach every host
    _fetch = staticmethod(np.asarray)

    _slice_chunk = staticmethod(slice_chunk)

    def _place_batch(self, q, qoff, qscale, n_full):
        sh = getattr(self, "_sh_d", None)
        return tuple(jax.device_put(x, sh) for x in (q, qoff, qscale, n_full))

    def _place_state(self, state):
        return state

    def _run_round(self, feats_r, counts_r, n_full_d, chunk_idx,
                   done, stopped, offsets, carry, rb_f, rb_i):
        m = self.cfg.mapping
        return turbo_round(
            self.tiles, self.meta, self.cum, self.rot, self.mu,
            self.origin, feats_r, counts_r,
            n_full_d, chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
            p=self.p, step=m.step_size, radius=m.search_radius,
            dim=self.index.dim, geom=self.geom,
            chain_cfg=self.cfg.chain, m=m,
        )

    def _unpack_host_sig(self, h: np.ndarray, B: int):
        return h[:B].astype(bool), h[B:].astype(bool)

    def _init_state(self, B: int):
        RING = self.p.RING
        carry = (
            jnp.full((RING, B), -(1 << 30), jnp.int32),   # t
            jnp.zeros((RING, B), jnp.int32),              # q
            jnp.full((RING, B), -2, jnp.int32),           # g
            jnp.full((RING, B), NEG, jnp.float32),        # score
            jnp.zeros((RING, B), jnp.int32),              # stt
            jnp.zeros((RING, B), jnp.int32),              # stq
            jnp.zeros((RING, B), jnp.int32),              # n
            jnp.zeros((RING, B), jnp.float32),            # sumd
        )
        rb_f = jnp.full((4, B), NEG, jnp.float32)
        rb_i = jnp.zeros((8, B), jnp.int32)
        return (
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool),
            jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32),
            carry, rb_f, rb_i,
        )

    def _emit(self, records, rid, s: ReadSignal, sf, si, chunk_idx,
              stopped_early, num_events, mt_ms, num_chunks):
        """Output decision + PAF record (sigmap.cc:690-866 semantics,
        mirroring Mapper._finish_fast)."""
        m = self.cfg.mapping
        if chunk_idx > 0 and not stopped_early:
            # loop-exhaustion adjustment (sigmap.cc:690-693)
            if chunk_idx == num_chunks or chunk_idx == m.max_num_chunks:
                chunk_idx -= 1
        ci = chunk_idx + 1
        sl = s.length
        s1, s2_raw, sumd1, s3_raw = (float(x) for x in sf[:4])
        g1, t_start, t_end, q_start, q_end, n1, nc, ovf = (
            int(x) for x in si
        )
        # same chain-candidacy gates as the round body (reference chain
        # selection, spatial_index.cc:230-247,545-546)
        min_sc = self.cfg.chain.min_chaining_score
        found = s1 >= min_sc
        has2 = found and s2_raw >= min_sc and 2.0 * s2_raw > s1
        has3 = has2 and s3_raw >= min_sc and 2.0 * s3_raw > s1
        s2 = s2_raw if has2 else 0.0
        s3 = s3_raw if has3 else 0.0
        nc = 1 + int(has2) + int(has3) if found else 0
        sm = (s1 + s2 + s3) / nc if nc else 0.0
        scale = 0.0
        if num_events > 0:
            scale = (ci * m.chunk_size / num_events) / (
                m.sample_rate / m.bp_per_sec
            )
        out_ok = found and (
            (has2 and (
                s1 / s2 >= m.output_mapping_ratio
                or s1 >= m.output_mapping_mean_ratio * sm
            ))
            or (nc == 1 and n1 >= m.output_mapping_min_num_anchors)
        )
        summ = None
        if found:
            summ = ChainsSummary(
                num_anchors=n1, num_chains=nc, s1=s1, s2=s2,
                sm=sm,
                ad=sumd1 / max(1, n1),
                at=(t_end - t_start) / max(1, n1),
                aq=(q_end - q_start) / max(1, n1),
            )
        if out_ok:
            ref_index = g1 // 2
            strand_bit = g1 % 2
            ref_len = self.index.ref_lengths[ref_index]
            tstart = t_start if strand_bit == 0 else ref_len + 1 - t_end
            mapq = 60 if nc == 1 else max(0, min(60, int(40 * (1 - s2 / s1))))
            records[rid] = PAFRecord(
                read_id=rid, read_name=s.read_id, read_length=sl,
                read_start=int(scale * q_start), read_end=int(scale * q_end),
                ref_index=ref_index, fragment_start=int(tstart),
                fragment_length=int(t_end - t_start + 1),
                mapq=mapq, direction=1 if strand_bit == 0 else 0,
                tags=streaming_tags(mt_ms, ci, sl, summ),
            )
        else:
            records[rid] = PAFRecord(
                read_id=rid, read_name=s.read_id, read_length=sl,
                read_start=0, read_end=0, ref_index=0, fragment_start=0,
                fragment_length=0, mapq=61, direction=0,
                tags=streaming_tags(mt_ms, ci, sl, summ),
            )
            if ovf and self._rescue_pool is not None:
                # unmapped AND capacity-truncated: the exact engine decides
                # (replaces the placeholder record when the future drains)
                self._rescue_futs.append(
                    self._rescue_pool.submit(self._rescue_one, rid, s, mt_ms)
                )
