"""Anchor chaining: scores, traceback, primary selection, MAPQ.

Host-side exact implementation of GenerateChains (spatial_index.cc:276-577):
the DP inner loop (banded, skip-capped) runs in native C++ per
(reference sequence, strand) group; selection/traceback/MAPQ are tiny and
stay in numpy/Python.  The device chainer for the turbo path is
ops/chain_fused.py.

Semantics preserved:
* anchors sorted by (target, query, distance) per group, carried anchors
  from previous chunks merged in (spatial_index.cc:302-322,410-417);
* max_chaining_score accumulates ACROSS groups in (signal, strand) order,
  gating end-anchor selection at score > max/2 (spatial_index.cc:542-549);
* end anchors sorted by (score desc, index desc), up to 3 tracebacks, a
  below-max/2 anchor is still traced before the loop breaks
  (spatial_index.cc:552-568);
* traceback stops at used anchors, subtracting their score
  (spatial_index.cc:165-220); chains need >= 2 anchors;
* primary chains: sort by the full descending tuple, drop overlapping-on-
  same-ref chains, stop when score < last-primary/3 (spatial_index.cc:222-253);
* MAPQ: 60 for a lone chain, else trunc(40*(1-s2/s1)) clamped to [0,60]
  on the best chain only (spatial_index.cc:255-274).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import ChainingConfig
from .. import native

POSITIVE = 1  # matches reference enum (spatial_index.h:13-16)
NEGATIVE = 0


@dataclass
class Chain:
    score: float
    ref_index: int
    start_position: int
    end_position: int
    num_anchors: int
    mapq: int
    direction: int  # POSITIVE/NEGATIVE
    anchors: np.ndarray  # structured [n] (target, query, dist), end->start

    def sort_key(self):
        """operator> tuple (spatial_index.h:38-44)."""
        return (
            self.score, self.num_anchors, self.direction, self.ref_index,
            self.start_position, self.end_position,
        )


ANCHOR_DTYPE = np.dtype(
    [("target", np.int64), ("query", np.int64), ("dist", np.float32)]
)


def make_anchors(target, query, dist) -> np.ndarray:
    a = np.empty(len(target), ANCHOR_DTYPE)
    a["target"] = target
    a["query"] = query
    a["dist"] = dist
    return a


def generate_chains(
    new_anchors: dict[tuple[int, int], np.ndarray],
    prev_chains: list[Chain],
    num_refs: int,
    search_radius: float,
    dim: int,
    cfg: ChainingConfig = ChainingConfig(),
) -> list[Chain]:
    """One GenerateChains pass for a single read.

    new_anchors: {(ref_index, strand_bit): ANCHOR_DTYPE array} where
    strand_bit 0 = positive (the packed-position convention,
    spatial_index.cc:47-52).  prev_chains: chains whose anchors are carried
    forward (streaming accumulation).
    """
    groups: dict[tuple[int, int], list[np.ndarray]] = {}
    for ch in prev_chains:
        sb = 0 if ch.direction == POSITIVE else 1
        groups.setdefault((ch.ref_index, sb), []).append(ch.anchors)
    for key, arr in new_anchors.items():
        if len(arr):
            groups.setdefault(key, []).append(arr)

    chains: list[Chain] = []
    max_score = 0.0
    for ref_idx in range(num_refs):
        for sb in (0, 1):  # positive list first (spatial_index.cc:420-422)
            parts = groups.get((ref_idx, sb))
            if not parts:
                continue
            anchors = np.concatenate(parts)
            order = np.lexsort(
                (anchors["dist"], anchors["query"], anchors["target"])
            )
            anchors = anchors[order]
            n = len(anchors)
            scores, pred = native.chain_scores(
                anchors["target"], anchors["query"], anchors["dist"],
                search_radius, dim,
                cfg.max_gap_length, cfg.max_target_gap_length,
                cfg.chaining_band_length, cfg.max_num_skips,
            )
            # running max across anchors AND groups; end-anchor selection
            # against the max *including this anchor* (spatial_index.cc:542-549)
            runmax = np.maximum.accumulate(
                np.maximum(scores, np.float32(max_score))
            )
            sel = (scores >= cfg.min_chaining_score) & (scores > runmax / 2)
            max_score = float(runmax[-1]) if n else max_score
            cand_idx = np.nonzero(sel)[0]
            if len(cand_idx) == 0:
                continue
            # sort by (score desc, index desc) (compare, spatial_index.cc:11-20)
            order2 = sorted(
                cand_idx.tolist(),
                key=lambda i: (-scores[i], -i),
            )
            used = np.zeros(n, bool)
            direction = POSITIVE if sb == 0 else NEGATIVE
            for rank, end_i in enumerate(order2[: cfg.num_best_chains]):
                _traceback(
                    anchors, scores, pred, used, end_i, ref_idx, direction,
                    cfg.min_num_anchors, chains,
                )
                if scores[end_i] < max_score / 2:
                    break

    if not chains:
        return []
    primary = _primary_chains(chains)
    _compute_mapq(primary)
    return primary


def _traceback(
    anchors, scores, pred, used, end_i, ref_idx, direction, min_num_anchors,
    chains: list[Chain],
) -> None:
    """TracebackChains (spatial_index.cc:165-220)."""
    if used[end_i]:
        return
    out = [end_i]
    stopped_at_used = False
    i = end_i
    if pred[i] != i and used[pred[i]]:
        stopped_at_used = True
    used[i] = True
    while pred[i] != i and not used[pred[i]]:
        i = pred[i]
        out.append(i)
        if pred[i] != i and used[pred[i]]:
            stopped_at_used = True
        used[i] = True
    if len(out) < min_num_anchors:
        return
    score = float(scores[end_i])
    if stopped_at_used:
        score -= float(scores[pred[i]])
    chains.append(
        Chain(
            score=score,
            ref_index=ref_idx,
            start_position=int(anchors["target"][i]),
            end_position=int(anchors["target"][end_i]),
            num_anchors=len(out),
            mapq=0,
            direction=direction,
            anchors=anchors[np.array(out)],
        )
    )


def _primary_chains(chains: list[Chain]) -> list[Chain]:
    """GeneratePrimaryChains (spatial_index.cc:222-253)."""
    chains = sorted(chains, key=lambda c: c.sort_key(), reverse=True)
    primary = [chains[0]]
    for c in chains[1:]:
        if c.score < primary[-1].score / 3:
            break
        is_primary = True
        for p in primary:
            if c.ref_index == p.ref_index:
                if not (
                    max(c.start_position, p.start_position)
                    > min(c.end_position, p.end_position)
                ):
                    is_primary = False
                    break
        if is_primary:
            primary.append(c)
    return primary


def _compute_mapq(chains: list[Chain]) -> None:
    """ComputeMAPQ (spatial_index.cc:255-274)."""
    if len(chains) == 1:
        chains[0].mapq = 60
        return
    mapq = int(40 * (1 - chains[1].score / chains[0].score))
    chains[0].mapq = max(0, min(60, mapq))
