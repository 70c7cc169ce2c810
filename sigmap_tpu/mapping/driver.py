"""Mapping drivers: whole-read batch mode and streaming mode.

Batched reformulation of Sigmap::Map (sigmap.cc:243-547) and
Sigmap::StreamingMap (sigmap.cc:549-880).  The reference parallelizes with
an OpenMP taskloop over reads; here reads advance in lockstep *wavefronts*:

  host: chunk assembly / chain state / early-stop decisions / PAF
  device (batched over the wavefront): event detection -> feature signals,
  seed radius-search against the HBM-resident index

Per-read decisions (chaining, stop rules, tag assembly) are tiny and stay
on host, with the exact-semantics native chainer.  Reads that finish leave
the wavefront and free their slot for pending reads (continuous batching).

Timing note: the reference measures true per-read wall time (mt:f tag,
sigmap.cc:633,698).  Batched execution amortizes device time over the
wavefront, so mt reports each read's share of the rounds it participated
in — the eval-protocol semantics (mean/median mapping time) are preserved.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..config import SigmapConfig
from ..index.build import SignalIndex
from ..io.paf import ChainsSummary, PAFRecord, batch_tags, streaming_tags
from ..io.signals import ReadSignal
from ..signal.events import batch_generate_events
from .chain import POSITIVE, Chain, generate_chains, make_anchors
from .seeding import DeviceIndex, flatten_matches, pad_seeds, search_flat


def _round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def chains_summary(chains: list["Chain"]) -> ChainsSummary:
    """Best-chain statistics (sigmap.cc:714-745)."""
    best = chains[0]
    a = best.anchors
    ad = float(a["dist"].sum()) / best.num_anchors
    at = float((a["target"][:-1] - a["target"][1:]).sum()) / best.num_anchors
    aq = float((a["query"][:-1] - a["query"][1:]).sum()) / best.num_anchors
    mean = sum(c.score for c in chains) / len(chains)
    return ChainsSummary(
        num_anchors=best.num_anchors, num_chains=len(chains),
        s1=best.score, s2=chains[1].score if len(chains) > 1 else 0.0,
        sm=mean, ad=ad, at=at, aq=aq,
    )


def mapped_record(index, rid, name, qlen, qstart, qend, chains, tags):
    best = chains[0]
    ref_len = index.ref_lengths[best.ref_index]
    if best.direction == POSITIVE:
        tstart = best.start_position
    else:
        tstart = ref_len + 1 - best.end_position
    return PAFRecord(
        read_id=rid, read_name=name, read_length=qlen,
        read_start=qstart, read_end=qend, ref_index=best.ref_index,
        fragment_start=int(tstart),
        fragment_length=int(best.end_position - best.start_position + 1),
        mapq=best.mapq, direction=1 if best.direction == POSITIVE else 0,
        tags=tags,
    )


def streaming_record(index, cfg, rid, name, sl, chunk_index_adj,
                     num_events, chains, mt_ms) -> PAFRecord:
    """Streaming output decision + record (sigmap.cc:694-866) from an
    ALREADY-ADJUSTED chunk index (the loop-exhaustion decrement applied).
    Shared by Mapper._finish_streaming and the turbo engine's exact-rescue
    pass."""
    m = cfg.mapping
    ci = chunk_index_adj + 1
    scale = 0.0
    if num_events > 0:
        scale = (ci * m.chunk_size / num_events) / (
            m.sample_rate / m.bp_per_sec
        )
    ch = chains or []
    mean = sum(c.score for c in ch) / len(ch) if ch else 0.0
    out_ok = (
        len(ch) >= 2
        and (
            ch[0].score / ch[1].score >= m.output_mapping_ratio
            or ch[0].score >= m.output_mapping_mean_ratio * mean
        )
    ) or (
        len(ch) == 1
        and ch[0].num_anchors >= m.output_mapping_min_num_anchors
    )
    if out_ok:
        summ = chains_summary(ch)
        tags = streaming_tags(mt_ms, ci, sl, summ)
        best = ch[0]
        return mapped_record(
            index, rid, name, sl,
            int(scale * best.anchors["query"][-1]),
            int(scale * best.anchors["query"][0]),
            ch, tags,
        )
    tags = streaming_tags(
        mt_ms, ci, sl, chains_summary(ch) if ch else None
    )
    return PAFRecord(
        read_id=rid, read_name=name, read_length=sl, read_start=0,
        read_end=0, ref_index=0, fragment_start=0, fragment_length=0,
        mapq=61, direction=0, tags=tags,
    )


@dataclass
class _ReadState:
    index: int
    signal: ReadSignal
    chunk_index: int = 0
    num_events: int = 0
    chains: list = field(default_factory=list)
    mt_ms: float = 0.0
    done: bool = False
    stopped_early: bool = False


class Mapper:
    def __init__(
        self,
        index: SignalIndex,
        config: SigmapConfig = SigmapConfig(),
    ):
        self.index = index
        self.cfg = config
        rt = config.runtime
        self.dev = DeviceIndex.from_host(
            index, radius=config.mapping.search_radius,
            seeds_per_tile=rt.seeds_per_tile, cap_per_seed=rt.cap_per_seed,
            surv_per_tile=rt.surv_per_tile,
            matches_per_tile=rt.matches_per_tile,
        )
        if rt.autotune_search:
            import dataclasses as _dc

            from .seeding import autotune_params

            tuned = autotune_params(self.dev, max_cap=rt.cap_per_seed)
            self.dev = _dc.replace(self.dev, params=tuned)
        if index.win_group is None:
            index.derive_window_metadata()
        self.num_refs = len(index.ref_names)

    # ------------------------------------------------------------ common --

    def _chunk_features(self, chunks: np.ndarray, lengths: np.ndarray,
                        max_events: int, max_features: int):
        feats, fstdvs, counts, nev = batch_generate_events(
            chunks, lengths, cfg=self.cfg.event,
            max_events=max_events, max_features=max_features,
            compress_delta=self.cfg.mapping.compress_delta,
        )
        return np.asarray(feats), np.asarray(counts)

    def _seed_windows(self, feats_row: np.ndarray, count: int, step: int):
        """Seed positions s, 2s, ... <= n-dim (position 0 is never seeded:
        the reference's previous_position=0 initialization skips it,
        spatial_index.cc:349-356)."""
        dim = self.index.dim
        n = int(count)
        if n - dim < step:
            return np.zeros(0, np.int64), np.zeros((0, 8), np.float32)
        positions = np.arange(step, n - dim + 1, step, dtype=np.int64)
        Wf = np.lib.stride_tricks.sliding_window_view(feats_row[:n], dim)
        out = np.zeros((len(positions), 8), np.float32)
        out[:, :dim] = Wf[positions]
        return positions, out

    def _search(self, seed_windows: np.ndarray):
        """Flat radius search; returns (seed_ids, window_idx, dist)."""
        if len(seed_windows) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        p = self.dev.params
        padded, valid, n_tiles = pad_seeds(seed_windows, p)
        # bucket tile counts to limit jit specializations
        n_tiles_b = 1 << max(0, (n_tiles - 1).bit_length())
        if n_tiles_b != n_tiles:
            pad2 = np.zeros((n_tiles_b * p.seeds_per_tile, 8), np.float32)
            pad2[: len(padded)] = padded
            v2 = np.zeros(n_tiles_b * p.seeds_per_tile, bool)
            v2[: len(valid)] = valid
            padded, valid, n_tiles = pad2, v2, n_tiles_b
        out = search_flat(self.dev, padded, valid, n_tiles)
        sids, widx, dist, _, ovf = flatten_matches(out, p)
        if ovf.any():
            import sys

            print(f"warning: seeding overflow flags {ovf}", file=sys.stderr)
        return sids, widx, dist

    def _anchors_by_group(self, widx, dist, qpos):
        """Decode window indices into per-(ref, strand) anchor arrays."""
        group = self.index.win_group[widx]
        tpos = self.index.win_pos[widx]
        out = {}
        for g in np.unique(group):
            sel = group == g
            out[(int(g) // 2, int(g) % 2)] = make_anchors(
                tpos[sel], qpos[sel], dist[sel]
            )
        return out

    def _chains_summary(self, chains: list[Chain]) -> ChainsSummary:
        return chains_summary(chains)

    def _mapped_record(self, rid, name, qlen, qstart, qend, chains, tags):
        return mapped_record(
            self.index, rid, name, qlen, qstart, qend, chains, tags
        )

    # --------------------------------------------------------- batch mode --

    def map_reads(self, signals: list[ReadSignal],
                  max_signal_len: int = 65536) -> list[PAFRecord]:
        """Whole-read mapping (Sigmap::Map, sigmap.cc:243-547): one event
        pass over the full read, seeding step 1, unconditional best-chain
        output.  Reads with <= 50 features produce no record (quirk:
        sigmap.cc:355 has no else branch)."""
        m = self.cfg.mapping
        records: list[PAFRecord] = []
        B = self.cfg.runtime.read_batch
        for base in range(0, len(signals), B):
            batch = signals[base : base + B]
            t0 = time.perf_counter()
            C = _round_up(
                min(max(s.length for s in batch), max_signal_len), 4096
            )
            chunks = np.zeros((len(batch), C), np.float32)
            lengths = np.zeros(len(batch), np.int32)
            for i, s in enumerate(batch):
                L = min(s.length, C)
                chunks[i, :L] = s.pa[:L]
                lengths[i] = L
            feats, counts = self._chunk_features(
                chunks, lengths, max_events=max(1024, C // 4),
                max_features=max(1024, C // 4),
            )
            seed_rows, seed_qpos, seed_read = [], [], []
            for i in range(len(batch)):
                if counts[i] > m.min_feature_length:
                    pos, wins = self._seed_windows(feats[i], counts[i], 1)
                    seed_rows.append(wins)
                    seed_qpos.append(pos)
                    seed_read.append(np.full(len(pos), i, np.int64))
            if seed_rows:
                all_wins = np.concatenate(seed_rows)
                all_qpos = np.concatenate(seed_qpos)
                all_read = np.concatenate(seed_read)
                sids, widx, dist = self._search(all_wins)
            else:
                sids = np.zeros(0, np.int64)
            elapsed_ms = (time.perf_counter() - t0) * 1000 / len(batch)
            for i, s in enumerate(batch):
                if counts[i] <= m.min_feature_length:
                    continue  # silently dropped (sigmap.cc:355)
                sel = (
                    (all_read[sids] == i)
                    if len(sids)
                    else np.zeros(0, bool)
                )
                groups = self._anchors_by_group(
                    widx[sel], dist[sel], all_qpos[sids[sel]]
                ) if sel.any() else {}
                chains = generate_chains(
                    groups, [], self.num_refs, m.search_radius,
                    self.index.dim, self.cfg.chain,
                )
                nfeat = int(counts[i])
                if chains:
                    best = chains[0]
                    tags = batch_tags(
                        elapsed_ms, s.length, self._chains_summary(chains)
                    )
                    records.append(
                        self._mapped_record(
                            base + i, s.read_id, nfeat,
                            int(best.anchors["query"][-1]),
                            int(best.anchors["query"][0]),
                            chains, tags,
                        )
                    )
                else:
                    records.append(
                        PAFRecord(
                            read_id=base + i, read_name=s.read_id,
                            read_length=nfeat, read_start=0, read_end=0,
                            ref_index=0, fragment_start=0, fragment_length=0,
                            mapq=61, direction=0,
                            tags=batch_tags(elapsed_ms, s.length, None),
                        )
                    )
        return records

    # ----------------------------------------------------- streaming mode --

    def streaming_map(self, signals: list[ReadSignal]) -> list[PAFRecord]:
        """Streaming mapping (Sigmap::StreamingMap, sigmap.cc:549-880):
        4000-sample chunks, carried chains, early-stop + output gating."""
        m = self.cfg.mapping
        rt = self.cfg.runtime
        states = [_ReadState(i, s) for i, s in enumerate(signals)]
        pending = list(reversed(states))
        active: list[_ReadState] = []
        records: dict[int, PAFRecord] = {}
        B = rt.read_batch
        Cs = m.chunk_size

        while pending or active:
            while len(active) < B and pending:
                st = pending.pop()
                if st.signal.length // Cs == 0 or m.max_num_chunks == 0:
                    # no full chunk ever processed -> immediate unmapped
                    self._finish_streaming(st, records)
                    continue
                active.append(st)
            if not active:
                break
            t0 = time.perf_counter()
            chunks = np.zeros((B, Cs), np.float32)
            lengths = np.zeros(B, np.int32)
            for i, st in enumerate(active):
                lo = st.chunk_index * Cs
                hi = min(lo + Cs, st.signal.length)
                seg = st.signal.pa[lo:hi]
                chunks[i, : len(seg)] = seg
                lengths[i] = len(seg)
            feats, counts = self._chunk_features(
                chunks, lengths, rt.max_events, rt.max_features
            )
            # flat seed assembly over the wavefront
            seed_rows, seed_qpos, seed_read = [], [], []
            for i, st in enumerate(active):
                if counts[i] > m.min_feature_length:
                    pos, wins = self._seed_windows(
                        feats[i], counts[i], m.step_size
                    )
                    seed_rows.append(wins)
                    seed_qpos.append(pos + st.num_events)
                    seed_read.append(np.full(len(pos), i, np.int64))
            if seed_rows:
                all_wins = np.concatenate(seed_rows)
                all_qpos = np.concatenate(seed_qpos)
                all_read = np.concatenate(seed_read)
                sids, widx, dist = self._search(all_wins)
            else:
                sids = np.zeros(0, np.int64)
            round_ms = (time.perf_counter() - t0) * 1000 / max(1, len(active))

            # per-read chaining is independent across reads; -t fans it over
            # a host thread pool (the native DP releases the GIL), the
            # analogue of the reference's OpenMP taskloop (sigmap.cc:618-631)
            def chain_one(i_st):
                i, st = i_st
                if counts[i] <= m.min_feature_length:
                    return None
                sel = (
                    (all_read[sids] == i) if len(sids)
                    else np.zeros(0, bool)
                )
                groups = self._anchors_by_group(
                    widx[sel], dist[sel], all_qpos[sids[sel]]
                ) if len(sids) and sel.any() else {}
                return generate_chains(
                    groups, st.chains, self.num_refs, m.search_radius,
                    self.index.dim, self.cfg.chain,
                )

            nthreads = rt.num_threads
            if nthreads > 1 and len(active) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(nthreads) as ex:
                    new_chains = list(ex.map(chain_one, enumerate(active)))
            else:
                new_chains = [chain_one(x) for x in enumerate(active)]

            still_active: list[_ReadState] = []
            for i, st in enumerate(active):
                st.mt_ms += round_ms
                stop = False
                if new_chains[i] is not None:
                    st.chains = new_chains[i]
                    st.num_events += int(counts[i])
                    ch = st.chains
                    if len(ch) >= 2:
                        if ch[0].score / ch[1].score >= m.stop_mapping_ratio:
                            stop = True
                        else:
                            mean = sum(c.score for c in ch) / len(ch)
                            if ch[0].score >= m.stop_mapping_mean_ratio * mean:
                                stop = True
                    elif (
                        len(ch) == 1
                        and ch[0].num_anchors >= m.stop_mapping_min_num_anchors
                    ):
                        stop = True
                # the reference's `break` on stop skips the loop increment,
                # so chunk_index stays at the stopped chunk (sigmap.cc:647-689)
                if stop:
                    st.stopped_early = True
                    self._finish_streaming(st, records)
                    continue
                st.chunk_index += 1
                exhausted = (
                    st.chunk_index >= st.signal.length // Cs
                    or st.chunk_index >= m.max_num_chunks
                )
                if exhausted:
                    self._finish_streaming(st, records)
                else:
                    still_active.append(st)
            active = still_active

        return [records[i] for i in range(len(signals)) if i in records]

    def _finish_streaming(self, st: _ReadState, records: dict) -> None:
        """Decision + emission (sigmap.cc:690-866)."""
        m = self.cfg.mapping
        chunk_index = st.chunk_index
        # loop-exhaustion adjustment (sigmap.cc:690-693)
        num_chunks = st.signal.length // m.chunk_size
        if chunk_index > 0 and (
            chunk_index == num_chunks or chunk_index == m.max_num_chunks
        ):
            chunk_index -= 1
        records[st.index] = streaming_record(
            self.index, self.cfg, st.index, st.signal.read_id,
            st.signal.length, chunk_index, st.num_events, st.chains,
            st.mt_ms,
        )
        st.done = True
