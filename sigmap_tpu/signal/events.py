"""Batched JAX event detection: raw signal chunks -> compressed feature
signals, on-device.

Batched reformulation of event.h:226-267 + sigmap.cc:1048-1083:

* prefix sums / t-statistics: vectorized fp32 cumsum + gathers over the
  whole [B, C] chunk batch (replaces the per-read loops, event.h:58-115);
* the dual-detector peak state machine (event.h:117-182) carries ~10 scalars
  per read, so it runs as a `lax.scan` over time with all reads advancing in
  lockstep (a Triton kernel for it was faster per call on an H100 but moved
  nothing end to end, since the scan runs once per batch on the prefetch
  thread; see PERF.md);
* ragged outputs (peaks, events, compressed features) are held as padded
  [B, E] arrays + counts, compacted with cumsum-scatter.

Semantics match signal/events_ref.py (the executable spec) exactly, up to
fp32 cumsum association differences.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EventDetectorConfig

FLT_MAX = np.float32(3.4028235e38)
FLT_MIN = np.float32(1.1754944e-38)


def batch_prefix_sums(chunks: jax.Array, lengths: jax.Array):
    """[B, C] -> fp32 prefix sums [B, C+1] of x and x**2 (event.h:58-68).
    Samples at/after `lengths` are zeroed so sums saturate at ps[L]."""
    B, C = chunks.shape
    idx = jnp.arange(C)[None, :]
    x = jnp.where(idx < lengths[:, None], chunks, 0.0).astype(jnp.float32)
    zero = jnp.zeros((B, 1), jnp.float32)
    ps = jnp.concatenate([zero, jnp.cumsum(x, axis=1)], axis=1)
    pss = jnp.concatenate([zero, jnp.cumsum(x * x, axis=1)], axis=1)
    return ps, pss


def batch_tstat(chunks: jax.Array, lengths: jax.Array, w: int):
    """Vectorized two-window Welch t-stat (event.h:70-115) -> [B, C].

    Positions outside [w, L-w] (and whole reads with L < 2w) are 0, matching
    the reference's zero-fudged boundaries.

    Numerical note: the reference derives the window sums from global fp32
    prefix sums, which suffers catastrophic cancellation (ulp(ps[i]) grows
    with i, so the windowed differences — and especially combined_var —
    carry position-dependent noise that wobbles t by ~20% right at event
    boundaries).  Here the w-windows (w <= 14) are summed *locally* via
    shifted adds, which is both more accurate than the C++ and
    deterministic across backends; downstream peak decisions can therefore
    differ from the reference only on peaks that are marginal under the
    reference's own rounding noise.
    """
    B, C = chunks.shape
    i = jnp.arange(C)[None, :]
    L = lengths[:, None]
    x = jnp.where(i < L, chunks, 0.0).astype(jnp.float32)
    pad = jnp.zeros((B, w), jnp.float32)
    xp = jnp.concatenate([pad, x, pad], axis=1)     # index i+w == x[i]
    inv_w = np.float32(1.0 / w)

    def shifted(a, off):
        return jax.lax.dynamic_slice_in_dim(a, w + off, C, axis=1)

    def wmean(lo):
        s = jnp.zeros((B, C), jnp.float32)
        for d in range(w):
            s = s + shifted(xp, lo + d)
        return s * inv_w

    def wvar(lo, mean):
        # centered two-pass variance: immune to the E[x^2]-E[x]^2
        # cancellation that injects ~1-5% noise into the C++ t-stat at
        # exactly the low-variance (sharp-boundary) positions
        s = jnp.zeros((B, C), jnp.float32)
        for d in range(w):
            dev = shifted(xp, lo + d) - mean
            s = s + dev * dev
        return s * inv_w

    mean1 = wmean(-w)        # window [i-w, i)
    mean2 = wmean(0)         # window [i, i+w)
    comb = jnp.maximum(wvar(-w, mean1) + wvar(0, mean2), FLT_MIN)
    t = jnp.abs(mean2 - mean1) / jnp.sqrt(comb * inv_w)
    valid = (i >= w) & (i <= L - w) & (L >= 2 * w)
    return jnp.where(valid, t, 0.0)


def _detector_step(state, v, i, threshold, wl, peak_height, active):
    """One step of one detector's state machine (event.h:127-179).

    state: dict(peak_pos i32[B], peak_value f32[B], valid bool[B],
                masked_to i32[B]).
    Returns (new_state, emit_pos i32[B]: position+1 or 0).
    """
    pp, pv, valid, masked = (
        state["peak_pos"], state["peak_value"], state["valid"],
        state["masked_to"],
    )
    act = active & (masked < i)
    in_def = pp == -1

    # CASE 1: no maximum recorded yet
    lower = v < pv
    fire = (~lower) & (v - pv > peak_height)
    pp1 = jnp.where(fire, i, pp)
    pv1 = jnp.where(lower | fire, v, pv)

    # CASE 2: inside a candidate peak
    upd = v > pv
    pp2 = jnp.where(upd, i, pp)
    pv2 = jnp.where(upd, v, pv)
    set_valid = (pv2 - v > peak_height) & (pv2 > threshold)
    valid2 = valid | set_valid
    emit = valid2 & ((i - pp2) > (wl // 2))
    pp2e = jnp.where(emit, -1, pp2)
    pv2e = jnp.where(emit, v, pv2)
    valid2e = valid2 & ~emit

    new = {
        "peak_pos": jnp.where(act, jnp.where(in_def, pp1, pp2e), pp),
        "peak_value": jnp.where(act, jnp.where(in_def, pv1, pv2e), pv),
        "valid": jnp.where(act, jnp.where(in_def, valid, valid2e), valid),
        "masked_to": masked,
    }
    emit_pos = jnp.where(act & (~in_def) & emit, pp2 + 1, 0)
    # info needed by the short-dominates-long rule: updated in-peak value/pos
    dominate = act & (~in_def) & (pv2 > threshold)
    return new, emit_pos, dominate, pp2


def detect_peaks_batch(
    tstat1: jax.Array, tstat2: jax.Array, lengths: jax.Array,
    cfg: EventDetectorConfig,
):
    """Batched dual-detector scan (event.h:117-182) -> emissions [B, 2C]
    (pos+1 | 0), ordered (step, short-then-long)."""
    B, C = tstat1.shape
    ph = np.float32(cfg.peak_height)

    def init_det():
        return {
            "peak_pos": jnp.full((B,), -1, jnp.int32),
            "peak_value": jnp.full((B,), FLT_MAX, jnp.float32),
            "valid": jnp.zeros((B,), bool),
            "masked_to": jnp.zeros((B,), jnp.int32),
        }

    def step(carry, xs):
        short, lng = carry
        v1, v2, i = xs
        active = i < lengths
        short_new, emit_s, dominate, short_pp = _detector_step(
            short, v1, i, np.float32(cfg.threshold1),
            cfg.window_length1, ph, active,
        )
        # short-dominates-long (event.h:155-164): applied before long runs
        lng = {
            "peak_pos": jnp.where(dominate, -1, lng["peak_pos"]),
            "peak_value": jnp.where(dominate, FLT_MAX, lng["peak_value"]),
            "valid": lng["valid"] & ~dominate,
            "masked_to": jnp.where(
                dominate, short_pp + cfg.window_length1, lng["masked_to"]
            ),
        }
        lng_new, emit_l, _, _ = _detector_step(
            lng, v2, i, np.float32(cfg.threshold2),
            cfg.window_length2, ph, active,
        )
        return (short_new, lng_new), jnp.stack([emit_s, emit_l], axis=-1)

    xs = (tstat1.T, tstat2.T, jnp.arange(C, dtype=jnp.int32))
    _, emits = jax.lax.scan(step, (init_det(), init_det()), xs)  # [C, B, 2]
    return emits.transpose(1, 0, 2).reshape(B, 2 * C)


def compact_nonzero(values: jax.Array, cap: int):
    """[B, N] (0 = empty) -> ([B, cap] packed, counts [B]).  Order-stable.

    Sort-based: a single-key row sort (nonzeros keep their column as the
    key, zeros get column + N) packs nonzeros to the front in order,
    without a scatter."""
    B, N = values.shape
    mask = values > 0
    col = jnp.arange(N, dtype=jnp.int32)[None, :]
    key = jnp.where(mask, col, col + N)
    counts = jnp.minimum(mask.sum(axis=1), cap).astype(jnp.int32)
    _, packed = jax.lax.sort((key, values), dimension=1, num_keys=1)
    packed = (packed[:, :cap] if N >= cap
              else jnp.pad(packed, ((0, 0), (0, cap - N))))
    keep = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(keep, packed, 0), counts


def events_from_peaks_batch(
    peaks: jax.Array, n_peaks: jax.Array, chunks: jax.Array,
    lengths: jax.Array, max_events: int,
):
    """CreateEvents (event.h:200-224), batched: boundaries [0, p_0..p_{n-2}, L].

    Per-event mean/stdv come from fp32 prefix-sum differences gathered at
    the segment boundaries — the reference's own formulation (CreateEvent,
    event.h:184-198), with no segment-sum scatter.  One accuracy upgrade
    over the C++: samples are centered by the chunk mean before the
    prefix sums, so the fp32 cancellation
    noise the reference carries (ulp(ps) grows with position) shrinks by
    ~3 orders of magnitude; the mean adds the chunk mean back exactly.

    Degenerate n<=1 handled as in events_ref.py.  Returns (means [B,E],
    stdvs [B,E], num_events [B]).
    """
    B, C = chunks.shape
    E = max_events
    n = n_peaks
    num_events = jnp.where(n == 0, 1, jnp.where(n == 1, 2, n)).astype(jnp.int32)
    j = jnp.arange(E)[None, :]
    L = lengths[:, None]
    # Q[j] = peaks[j] for j < n else L
    Q = jnp.where(j < n[:, None], peaks[:, :E], L)
    start = jnp.where(j == 0, 0, jnp.take_along_axis(Q, jnp.maximum(j - 1, 0), 1))
    end = jnp.where(j == num_events[:, None] - 1, L, Q)
    valid = j < num_events[:, None]
    start = jnp.clip(start, 0, L)
    end = jnp.clip(end, start + 1, None)  # avoid div-by-0 on padding

    t = jnp.arange(C)[None, :]
    in_len = t < L
    x = jnp.where(in_len, chunks, 0.0).astype(jnp.float32)
    nf = jnp.maximum(L.astype(jnp.float32), 1.0)
    cmean = jnp.sum(x, axis=1, keepdims=True) / nf
    xc = jnp.where(in_len, x - cmean, 0.0)
    zero = jnp.zeros((B, 1), jnp.float32)
    ps = jnp.concatenate([zero, jnp.cumsum(xc, axis=1)], axis=1)
    pss = jnp.concatenate([zero, jnp.cumsum(xc * xc, axis=1)], axis=1)
    seg = (jnp.take_along_axis(ps, end, axis=1)
           - jnp.take_along_axis(ps, start, axis=1))
    seg_sq = (jnp.take_along_axis(pss, end, axis=1)
              - jnp.take_along_axis(pss, start, axis=1))
    length = (end - start).astype(jnp.float32)
    mc = seg / length
    means = mc + cmean
    var = seg_sq / length - mc * mc
    stdvs = jnp.sqrt(jnp.maximum(var, 0.0))
    means = jnp.where(valid, means, 0.0)
    stdvs = jnp.where(valid, stdvs, 0.0)
    return means, stdvs, num_events


def zscore_masked(x: jax.Array, n: jax.Array):
    """Masked z-score along axis 1: population mean, (n-1) variance
    (sigmap.cc:1131-1155; fp32 accumulation here vs double in the C++)."""
    valid = jnp.arange(x.shape[1])[None, :] < n[:, None]
    nf = n.astype(jnp.float32)[:, None]
    mean = jnp.sum(jnp.where(valid, x, 0.0), axis=1, keepdims=True) / nf
    d = jnp.where(valid, x - mean, 0.0)
    sd = jnp.sqrt(jnp.sum(d * d, axis=1, keepdims=True) / (nf - 1.0))
    return jnp.where(valid, (x - mean) / sd, 0.0)


def compress_features_batch(
    norm: jax.Array, stdvs: jax.Array, n: jax.Array, delta: float,
    max_features: int,
):
    """Delta run-collapse scan (sigmap.cc:1072-1079), batched.

    Returns (features [B,F], stdvs [B,F], counts [B]).
    """
    B, E = norm.shape

    def step(last, xs):
        v, s, j = xs
        valid = j < n
        keep = valid & ((j == 0) | (jnp.abs(v - last) > delta))
        last = jnp.where(keep, v, last)
        return last, keep

    xs = (norm.T, stdvs.T, jnp.arange(E, dtype=jnp.int32))
    _, keeps = jax.lax.scan(step, jnp.zeros((B,), jnp.float32), xs)
    keep = keeps.T  # [B, E]
    counts = jnp.minimum(keep.sum(axis=1), max_features).astype(jnp.int32)
    # pack kept entries to the front with a single-key row sort (scatter-
    # free; same trick as compact_nonzero)
    col = jnp.arange(E, dtype=jnp.int32)[None, :]
    key = jnp.where(keep, col, col + E)
    _, feats, outs = jax.lax.sort(
        (key, norm, stdvs), dimension=1, num_keys=1
    )
    F = max_features
    feats = feats[:, :F] if E >= F else jnp.pad(feats, ((0, 0), (0, F - E)))
    outs = outs[:, :F] if E >= F else jnp.pad(outs, ((0, 0), (0, F - E)))
    live = jnp.arange(F, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(live, feats, 0.0), jnp.where(live, outs, 0.0), counts


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_events", "max_features", "compress_delta",
    ),
)
def batch_generate_events(
    chunks: jax.Array,
    lengths: jax.Array,
    cfg: EventDetectorConfig = EventDetectorConfig(),
    max_events: int = 1024,
    max_features: int = 1024,
    compress_delta: float = 0.1,
):
    """Full device pipeline for a chunk batch: [B, C] raw pA samples ->
    (features [B,F], feature_stdvs [B,F], feature_counts [B], event_counts [B]).

    Equivalent to per-read GenerateEvents (sigmap.cc:1048-1083).
    """
    t1 = batch_tstat(chunks, lengths, cfg.window_length1)
    t2 = batch_tstat(chunks, lengths, cfg.window_length2)
    emits = detect_peaks_batch(t1, t2, lengths, cfg)
    peaks1, n_peaks = compact_nonzero(emits, max_events)
    peaks = peaks1 - 1  # stored as pos+1
    means, stdvs, num_events = events_from_peaks_batch(
        peaks, n_peaks, chunks, lengths, max_events
    )
    norm = zscore_masked(means, num_events)
    feats, fstdvs, counts = compress_features_batch(
        norm, stdvs, num_events, compress_delta, max_features
    )
    return feats, fstdvs, counts, num_events


def events_means_batch(
    peaks: jax.Array, n_peaks: jax.Array, chunks: jax.Array,
    lengths: jax.Array, max_events: int,
):
    """events_from_peaks_batch without the stdv branch: one centered
    prefix sum + two boundary gathers.  The turbo engine consumes only
    compressed MEANS (seed windows), so the pss cumsum and its gathers —
    about half the stage's cost — are skipped."""
    B, C = chunks.shape
    E = max_events
    n = n_peaks
    num_events = jnp.where(n == 0, 1, jnp.where(n == 1, 2, n)).astype(jnp.int32)
    j = jnp.arange(E)[None, :]
    L = lengths[:, None]
    Q = jnp.where(j < n[:, None], peaks[:, :E], L)
    start = jnp.where(j == 0, 0, jnp.take_along_axis(Q, jnp.maximum(j - 1, 0), 1))
    end = jnp.where(j == num_events[:, None] - 1, L, Q)
    valid = j < num_events[:, None]
    start = jnp.clip(start, 0, L)
    end = jnp.clip(end, start + 1, None)

    t = jnp.arange(C)[None, :]
    in_len = t < L
    x = jnp.where(in_len, chunks, 0.0).astype(jnp.float32)
    nf = jnp.maximum(L.astype(jnp.float32), 1.0)
    cmean = jnp.sum(x, axis=1, keepdims=True) / nf
    xc = jnp.where(in_len, x - cmean, 0.0)
    zero = jnp.zeros((B, 1), jnp.float32)
    ps = jnp.concatenate([zero, jnp.cumsum(xc, axis=1)], axis=1)
    seg = (jnp.take_along_axis(ps, end, axis=1)
           - jnp.take_along_axis(ps, start, axis=1))
    length = (end - start).astype(jnp.float32)
    means = seg / length + cmean
    return jnp.where(valid, means, 0.0), num_events


def compress_means_batch(norm, keep, max_features):
    """Pack kept z-scored means to the front (no stdv payload)."""
    B, E = norm.shape
    counts = jnp.minimum(keep.sum(axis=1), max_features).astype(jnp.int32)
    col = jnp.arange(E, dtype=jnp.int32)[None, :]
    key = jnp.where(keep > 0, col, col + E)
    _, feats = jax.lax.sort((key, norm), dimension=1, num_keys=1)
    F = max_features
    feats = feats[:, :F] if E >= F else jnp.pad(feats, ((0, 0), (0, F - E)))
    live = jnp.arange(F, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(live, feats, 0.0), counts


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "max_events", "max_features", "compress_delta",
    ),
)
def batch_generate_features(
    chunks: jax.Array,
    lengths: jax.Array,
    cfg: EventDetectorConfig = EventDetectorConfig(),
    max_events: int = 1024,
    max_features: int = 1024,
    compress_delta: float = 0.1,
):
    """Lean turbo feature path: like batch_generate_events but means-only
    (no stdvs).  Returns (features [B,F], feature_counts [B])."""
    t1 = batch_tstat(chunks, lengths, cfg.window_length1)
    t2 = batch_tstat(chunks, lengths, cfg.window_length2)
    emits = detect_peaks_batch(t1, t2, lengths, cfg)
    peaks1, n_peaks = compact_nonzero(emits, max_events)
    peaks = peaks1 - 1
    means, num_events = events_means_batch(
        peaks, n_peaks, chunks, lengths, max_events
    )
    norm = zscore_masked(means, num_events)

    # delta run-collapse keep mask (sigmap.cc:1072-1079): <= max_events
    # trivial steps once per batch, off the round loop
    def step(last, xs):
        v, j = xs
        valid = j < num_events
        keep = valid & ((j == 0) | (jnp.abs(v - last) > compress_delta))
        last = jnp.where(keep, v, last)
        return last, keep

    _, keeps = jax.lax.scan(
        step,
        jnp.zeros((norm.shape[0],), jnp.float32),
        (norm.T, jnp.arange(norm.shape[1], dtype=jnp.int32)),
    )
    keep = keeps.T.astype(jnp.int32)
    feats, counts = compress_means_batch(norm, keep, max_features)
    return feats, counts
