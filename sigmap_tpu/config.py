"""Typed configuration for the whole framework.

The reference (haowenz/sigmap) scatters its operating point across cxxopts
defaults (sigmap.cc:1380-1419), hardcoded chaining constants
(spatial_index.cc:284-291), event-detector presets (event.h:31-43), chunking
constants (sigmap.cc:637-639) and magic numbers (signal_batch.cc:142-143,
sigmap.cc:1014,1075; spatial_index.cc:46).  Here every knob lives in one
dataclass tree so the CLI, the JAX pipeline, the native oracle and the tests
all share a single source of truth.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class EventDetectorConfig:
    """Two-window Welch t-test event segmentation (reference: event.h:31-43).

    DNA preset = event_detection_defaults; RNA preset = event_detection_rna.
    """

    window_length1: int = 3
    window_length2: int = 6
    threshold1: float = 4.30265
    threshold2: float = 2.57058
    peak_height: float = 1.0

    @staticmethod
    def dna() -> "EventDetectorConfig":
        return EventDetectorConfig()

    @staticmethod
    def rna() -> "EventDetectorConfig":
        return EventDetectorConfig(
            window_length1=7, window_length2=14, threshold1=2.5, threshold2=9.0
        )


@dataclass(frozen=True)
class IndexConfig:
    """Reference-signal index construction (reference: sigmap.cc:999-1046,
    spatial_index.cc:33-103)."""

    dimension: int = 6          # window dim (sigmap.cc:1422)
    max_leaf: int = 20          # kept for .pt format parity (sigmap.cc:1426)
    mask_frequency: float = 0.0002   # high-freq k-mer mask (sigmap.cc:1014)
    dedup_delta: float = 0.01   # consecutive-point dedup (spatial_index.cc:46)
    # device search-structure knobs (no reference equivalent: replaces
    # nanoflann)
    bucket_dims: int = 6        # leading window dims used for grid bucketing
    # cell width per bucketed dim, in units of sqrt(search_radius); smaller
    # cells = fewer candidates but more probes (3 cells/dim at 1.0, 2 at 2.0)
    cell_width_factor: float = 1.0


@dataclass(frozen=True)
class ChainingConfig:
    """Anchor chaining DP constants (reference: spatial_index.cc:284-291)."""

    max_gap_length: int = 2000
    max_target_gap_length: int = 5000
    chaining_band_length: int = 5000
    max_num_skips: int = 25
    min_num_anchors: int = 2
    num_best_chains: int = 3
    num_nearest_points: int = 5000   # per-seed anchor cap (spatial_index.cc:290)
    min_chaining_score: float = 10.0
    # gap gates (spatial_index.cc:511-512)
    max_gap_scale: float = 5.0
    min_gap_scale: float = 0.75
    # banded-scan window (device chainer); host/native chainer is exact.
    device_band: int = 64


@dataclass(frozen=True)
class MappingConfig:
    """Mapping-time knobs (reference: sigmap.cc:1380-1419,637-639)."""

    search_radius: float = 0.08       # squared-L2 (sigmap.cc:1380)
    step_size: int = 2                # seeding stride, streaming (sigmap.cc:1384)
    max_num_chunks: int = 30          # sigmap.cc:1392
    stop_mapping_min_num_anchors: int = 10
    output_mapping_min_num_anchors: int = 10
    stop_mapping_ratio: float = 1.4
    output_mapping_ratio: float = 1.2
    stop_mapping_mean_ratio: float = 5.0
    output_mapping_mean_ratio: float = 5.0
    # streaming constants (sigmap.cc:637-639)
    bp_per_sec: int = 450
    sample_rate: int = 4000
    chunk_size: int = 4000
    # feature compression threshold (sigmap.cc:1075)
    compress_delta: float = 0.1
    # minimum feature-signal length to attempt mapping (sigmap.cc:355,660)
    min_feature_length: int = 50
    # pA validity range; samples OUTSIDE (lo, hi) are dropped, not clipped
    # (signal_batch.cc:142-143)
    pa_lo: float = 30.0
    pa_hi: float = 200.0


@dataclass(frozen=True)
class RuntimeConfig:
    """Device execution knobs (no reference equivalent)."""

    read_batch: int = 128         # reads mapped concurrently per device step
    # host-side worker threads (the reference's -t, sigmap.cc:1340-1341):
    # parallelizes transport quantization + PAF emission in the turbo
    # engine and per-read chaining/decisions in the exact engine
    num_threads: int = 1
    max_events: int = 1024        # event slots per 4000-sample chunk
    max_features: int = 1024      # compressed feature slots per chunk
    # exact-engine radius-search tiling (see mapping/seeding.py); the turbo
    # engine sizes itself via TurboParams (mapping/turbo.py)
    seeds_per_tile: int = 64
    cap_per_seed: int = 32768     # candidate budget per seed
    surv_per_tile: int = 262144   # stage-2 survivors per tile
    matches_per_tile: int = 32768
    autotune_search: bool = True  # size candidate budgets from the index
    # on-disk cache dir for the turbo sweep layout (None = rebuild each
    # run; ~15 s host work at 12 Mb).  No reference equivalent (the
    # reference persists .pt/.si instead, spatial_index.cc:105-130).
    sweep_cache_dir: str | None = None


@dataclass(frozen=True)
class SigmapConfig:
    event: EventDetectorConfig = field(default_factory=EventDetectorConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    chain: ChainingConfig = field(default_factory=ChainingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "SigmapConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SigmapConfig()
