"""Multi-chip turbo mapping: reads data-parallel x sweep index sharded.

Replacement for the reference's only scale-out mechanism (an
OpenMP taskloop over reads with per-thread output buffers,
/root/reference/src/sigmap.cc:618-631,217-241), extended with index
sharding the reference never had (its k-d tree must fit in one host's
RAM, spatial_index.cc:132-163):

* mesh ("data", "index"): reads are sharded over "data"; the cell-sorted
  sweep tile store (index/sweep.py) is sharded over "index" as contiguous
  tile ranges, each shard with a rebased cumulative cell table — a
  shard's local window range for any cell is clip(cum - shard_start, 0,
  shard_windows), so per-shard sweeps stay purely local streams;
* each device runs the SAME turbo round body (mapping/turbo.py) on its
  local reads x local tiles; per-seed match slots merge across "index"
  with one all_gather + top-K-by-distance (K = per-seed cap), and exact
  match totals merge with a psum — the only collectives in the loop;
* chaining/stop/summary state is data-sharded and index-replicated, so
  the emitted PAF records are identical to the single-device turbo
  engine: the merge keeps the K smallest (d^2, meta) across shards, in
  that order, which is what the single-device search returns.

Scaling contract: reads scale over "data" (the reference's -t analogue),
genome size scales over "index" (human-scale point clouds split across
device memories).  tests/test_turbo_shard.py checks record-for-record
PAF equality vs single-device on mesh shapes (4,2), (2,4), (8,1) on the
virtual CPU mesh; `chip_smoke.py --four` checks it on four GPUs.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SigmapConfig
from ..index.build import SignalIndex
from ..index.sweep import PAD_COORD, SweepIndex
from ..mapping.turbo import TurboMapper, TurboParams, turbo_round_body

INF = np.float32(1.0e30)
IMAX = np.int32(2**31 - 1)


@dataclass
class ShardedSweep:
    """SweepIndex split into I contiguous tile ranges + rebased cum."""

    tiles: np.ndarray   # [I, Tl, 8, TILE]
    meta: np.ndarray    # [I, Tl, TILE]
    cum: np.ndarray     # [I, prod(radixes)+1] rebased per shard
    rot: np.ndarray     # [dim, dim] (replicated)
    mu: np.ndarray      # [dim]
    origin: np.ndarray  # [bd]
    geom: tuple         # (radixes, span, cell_width) — static
    n_windows: int
    tile: int

    @staticmethod
    def build(idx: SignalIndex, radius: float, n_shards: int,
              tile: int = 1024,
              cache_dir: str | None = None) -> "ShardedSweep":
        sw = SweepIndex.build_cached(idx, radius, tile=tile,
                                     cache_dir=cache_dir)
        T = sw.n_tiles
        Tl = -(-T // n_shards)
        pad = Tl * n_shards - T
        tiles = sw.tiles
        meta = sw.meta
        if pad:
            pt = np.zeros((pad, 8, tile), np.float32)
            pt[:, 0, :] = PAD_COORD
            tiles = np.concatenate([tiles, pt], axis=0)
            meta = np.concatenate(
                [meta, np.zeros((pad, tile), np.int32)], axis=0
            )
        W_l = Tl * tile
        cum = np.stack([
            np.clip(sw.cum.astype(np.int64) - i * W_l, 0, W_l).astype(np.int32)
            for i in range(n_shards)
        ])
        return ShardedSweep(
            tiles=tiles.reshape(n_shards, Tl, 8, tile),
            meta=meta.reshape(n_shards, Tl, tile),
            cum=cum, rot=sw.rot, mu=sw.mu, origin=sw.origin,
            geom=(sw.radixes, sw.span, sw.cell_width),
            n_windows=sw.n_windows, tile=tile,
        )


def make_sharded_round(mesh: Mesh, p: TurboParams, step, radius, dim,
                       geom, chain_cfg, m):
    """Build the jitted multi-chip round: shard_map over ("data", "index")."""
    K = p.K
    n_index = mesh.shape["index"]

    def merge_matches(m_meta, m_d2, cnt, wrote):
        Q = m_meta.shape[0]
        am = jax.lax.all_gather(m_meta, "index")          # [I, Q, K]
        ad = jax.lax.all_gather(m_d2, "index")
        aw = jax.lax.all_gather(wrote, "index")
        aw = jnp.broadcast_to(aw[:, :, None], am.shape)
        valid = jnp.arange(K)[None, None, :] < aw
        # the K smallest by (d^2, meta) over all shards, in that order:
        # the single-device search's kept set and slot order
        d = jnp.where(valid, ad, INF).transpose(1, 0, 2).reshape(Q, -1)
        mm = jnp.where(valid, am, IMAX).transpose(1, 0, 2).reshape(Q, -1)
        d, mm = jax.lax.sort((d, mm), dimension=1, num_keys=2)
        wrote_m = jnp.minimum(aw[:, :, 0].sum(axis=0), K).astype(jnp.int32)
        kept = jnp.arange(K)[None, :] < wrote_m[:, None]
        cnt_m = jax.lax.psum(cnt, "index")
        return (jnp.where(kept, mm[:, :K], 0), jnp.where(kept, d[:, :K], 0.0),
                cnt_m, wrote_m)

    def shard_fn(tiles_l, meta_l, cum_l, rot_l, mu_l, org_l, feats_l,
                 counts_l, n_full_l, ci_l, done_l,
                 st_l, off_l, carry_l, rbf_l, rbi_l):
        return turbo_round_body(
            tiles_l[0], meta_l[0], cum_l[0], rot_l, mu_l, org_l, feats_l,
            counts_l, n_full_l, ci_l,
            done_l, st_l, off_l, carry_l, rbf_l, rbi_l,
            p, step, radius, dim, geom, chain_cfg, m,
            merge_matches=merge_matches,
        )

    d = P("data")
    nd = P(None, "data")
    in_specs = (
        P("index"), P("index"), P("index"),               # tiles, meta, cum
        P(), P(), P(),                                    # rot, mu, origin
        d, d,                                             # feats_r, counts_r
        d, d, d, d, d,                                    # n_full..offsets
        (nd,) * 8,                                        # carry
        nd, nd,                                           # rb_f, rb_i
    )
    out_specs = (
        d, d, d, d,                                       # chunk/done/stop/off
        (nd,) * 8,                                        # carry
        nd, nd,                                           # rb_f, rb_i
        d,                                                # counts
        d,                                                # ovf -> [2*D]
        d,                                                # host_sig -> [D*(Bl+2)]
    )
    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


class TurboShardMapper(TurboMapper):
    """TurboMapper over a ("data", "index") device mesh.

    Same host API and PAF semantics as TurboMapper; reads and index are
    placed with NamedSharding so XLA runs each round SPMD across the mesh
    (data-parallel reads, index tiles sharded across device memories)."""

    def __init__(self, index: SignalIndex, config: SigmapConfig,
                 mesh: Mesh, params: TurboParams | None = None):
        self.index = index
        self.cfg = config
        if index.win_group is None:
            index.derive_window_metadata()
        self.num_refs = len(index.ref_names)
        self.p = params = params or TurboParams()
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.n_index = mesh.shape["index"]
        if config.runtime.read_batch % self.n_data:
            raise ValueError("read_batch must divide the data axis")
        ss = ShardedSweep.build(
            index, config.mapping.search_radius, self.n_index,
            tile=params.TILE, cache_dir=config.runtime.sweep_cache_dir,
        )
        sh_i = NamedSharding(mesh, P("index"))
        sh_r = NamedSharding(mesh, P())
        self.tiles = jax.device_put(ss.tiles, sh_i)
        self.meta = jax.device_put(ss.meta, sh_i)
        self.cum = jax.device_put(ss.cum, sh_i)
        self.rot = jax.device_put(ss.rot, sh_r)
        self.mu = jax.device_put(ss.mu, sh_r)
        self.origin = jax.device_put(ss.origin, sh_r)
        self.geom = ss.geom
        from concurrent.futures import ThreadPoolExecutor
        import threading

        self._uploader = ThreadPoolExecutor(1)
        self._oracle = None
        self._oracle_lock = threading.Lock()
        self._oracle_kicked = False
        self._rescue_pool = (
            ThreadPoolExecutor(max(1, config.runtime.num_threads))
            if self.p.rescue else None
        )
        self._rescue_futs = []
        self._ovf_warned = False
        m = config.mapping
        self._round = make_sharded_round(
            mesh, params, m.step_size, m.search_radius, index.dim,
            ss.geom, config.chain, m,
        )
        self._sh_d = NamedSharding(mesh, P("data"))
        self._sh_r = sh_r
        self._sh_nd = NamedSharding(mesh, P(None, "data"))
        if jax.process_count() > 1:
            # multi-host: data-sharded rows live on remote processes; pull
            # them with a tiled allgather (the cross-host analogue of the
            # reference's thread-buffer merge, sigmap.cc:217-241).  The
            # prefetch-thread batch overlap is disabled: every process
            # must enqueue global computations in the same order.
            from jax.experimental import multihost_utils

            self._fetch = lambda x: np.asarray(
                multihost_utils.process_allgather(x, tiled=True)
            )
            self._overlap_batches = False

    # --- hooks used by TurboMapper._map_batch ---------------------------

    def _place_batch(self, q, qoff, qscale, n_full):
        sh = self._sh_d
        return (
            jax.device_put(q, sh), jax.device_put(qoff, sh),
            jax.device_put(qscale, sh), jax.device_put(n_full, sh),
        )

    def _place_state(self, state):
        chunk_idx, done, stopped, offsets, carry, rb_f, rb_i = state
        put = jax.device_put
        return (
            put(chunk_idx, self._sh_d), put(done, self._sh_d),
            put(stopped, self._sh_d), put(offsets, self._sh_d),
            tuple(put(c, self._sh_nd) for c in carry),
            put(rb_f, self._sh_nd), put(rb_i, self._sh_nd),
        )

    def _run_round(self, feats_r, counts_r, n_full_d, chunk_idx,
                   done, stopped, offsets, carry, rb_f, rb_i):
        return self._round(
            self.tiles, self.meta, self.cum, self.rot, self.mu,
            self.origin, feats_r, counts_r, n_full_d,
            chunk_idx, done, stopped, offsets, carry, rb_f, rb_i,
        )

    def _unpack_host_sig(self, h: np.ndarray, B: int):
        """host_sig sharded over "data" concatenates per-shard [Bl+2]
        blocks: [D, Bl+2] -> done [B], ovf [2]."""
        Bl = B // self.n_data
        h = h.reshape(self.n_data, Bl + 2)
        done = h[:, :Bl].reshape(B).astype(bool)
        ovf = h[:, Bl:].any(axis=0).astype(bool)
        return done, ovf
