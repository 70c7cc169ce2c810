"""Command-line interface, flag-compatible with the reference sigmap binary.

Reference: SigmapDriver::ParseArgsAndRun (sigmap.cc:1329-1519).

  index:  python -m sigmap_tpu.cli -i -r ref.fa -p pore.model -o out_prefix
  map:    python -m sigmap_tpu.cli -m -r ref.fa -p pore.model -x out_prefix \
              -s signal_dir -o out.paf [-t N] [--step-size 2] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sigmap-tpu", description="Map ONT raw signal data (JAX/XLA)"
    )
    ap.add_argument("-i", "--build-index", action="store_true",
                    help="Build spatial index for reference")
    ap.add_argument("-m", "--map", action="store_true", help="Map signal data")
    ap.add_argument("-d", "--dimension", type=int, default=6,
                    help="Dimension of spatial index [6]")
    ap.add_argument("-l", "--max-leaf", type=int, default=20,
                    help="Max leaf of spatial index [20] (kept for .pt parity)")
    ap.add_argument("--step-size", type=int, default=2,
                    help="Seeding step size in reads [2]")
    ap.add_argument("-t", "--num-threads", type=int, default=1,
                    help="# threads for host-side work (quantization/"
                         "emission in turbo, per-read chaining in exact) "
                         "[1]")
    ap.add_argument("-r", "--ref", type=str, help="Reference file")
    ap.add_argument("-p", "--pore-model", type=str, help="Pore model file")
    ap.add_argument("-x", "--ref-index", type=str, help="Reference index file")
    ap.add_argument("-s", "--sig-dir", type=str, help="Signal data directory")
    ap.add_argument("-o", "--output", type=str, help="Output file")
    ap.add_argument("--search-radius", type=float, default=0.08,
                    help="Search radius for each seed [0.08]")
    ap.add_argument("--max-num-chunks", type=int, default=30,
                    help="Max # chunks before stop trying to map a read [30]")
    ap.add_argument("--min-num-anchors", type=int, default=10,
                    help="Min # anchors to stop mapping [10]")
    ap.add_argument("--min-num-anchors-output", type=int, default=10,
                    help="Min # anchors to output mappings [10]")
    ap.add_argument("--stop-mapping", type=float, default=1.4,
                    help="Best/second-best score ratio to stop mapping [1.4]")
    ap.add_argument("--stop-mapping-output", type=float, default=1.2,
                    help="Best/second-best score ratio to output mappings [1.2]")
    ap.add_argument("--stop-mapping-mean", type=float, default=5.0,
                    help="Best/mean score ratio to stop mapping [5]")
    ap.add_argument("--stop-mapping-mean-output", type=float, default=5.0,
                    help="Best/mean score ratio to output mappings [5]")
    ap.add_argument("--batch-mode", action="store_true",
                    help="Whole-read (non-streaming) mapping, like Sigmap::Map")
    ap.add_argument(
        "--engine", choices=["turbo", "exact"], default="turbo",
        help="Streaming engine: turbo (device-resident rounds, the "
             "production path) or exact (host chaining oracle) [turbo]")
    ap.add_argument("--read-batch", type=int, default=128,
                    help="Reads mapped concurrently on device [128]")
    ap.add_argument("--rna", action="store_true",
                    help="RNA event-detector preset (event.h:39-43)")
    ap.add_argument(
        "--debug-mode",
        choices=["dtw-align", "cwt-align", "fast5-to-text", "events-to-text"],
        help="Run a reference debug mode instead of mapping "
             "(sigmap.cc:1499-1504 dormant paths)",
    )
    return ap


def make_config(args) -> "SigmapConfig":
    from .config import (
        IndexConfig, MappingConfig, RuntimeConfig, SigmapConfig,
    )

    from .config import EventDetectorConfig

    return SigmapConfig(
        event=(
            EventDetectorConfig.rna() if getattr(args, "rna", False)
            else EventDetectorConfig.dna()
        ),
        index=IndexConfig(dimension=args.dimension, max_leaf=args.max_leaf),
        mapping=MappingConfig(
            search_radius=args.search_radius, step_size=args.step_size,
            max_num_chunks=args.max_num_chunks,
            stop_mapping_min_num_anchors=args.min_num_anchors,
            output_mapping_min_num_anchors=args.min_num_anchors_output,
            stop_mapping_ratio=args.stop_mapping,
            output_mapping_ratio=args.stop_mapping_output,
            stop_mapping_mean_ratio=args.stop_mapping_mean,
            output_mapping_mean_ratio=args.stop_mapping_mean_output,
        ),
        runtime=RuntimeConfig(read_batch=args.read_batch,
                              num_threads=args.num_threads),
    )


def run_index(args) -> int:
    from .index.build import build_index
    from .io.fasta import read_fasta
    from .io.pore_model import PoreModel

    for flag, name in ((args.ref, "reference"), (args.pore_model, "pore model"),
                       (args.output, "output")):
        if not flag:
            print(f"No {name} file specified!", file=sys.stderr)
            return 1
    cfg = make_config(args)
    pore = PoreModel.load(args.pore_model)
    seqs = read_fasta(args.ref)
    t0 = time.time()
    idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius)
    idx.save(args.output)
    idx.save_pt(args.output + ".pt")
    print(
        f"Built index successfully in {time.time()-t0:.1f}s.", file=sys.stderr
    )
    return 0


def run_map(args) -> int:
    from .index.build import SignalIndex
    from .io.paf import PAFWriter
    from .io.signals import load_all_read_signals

    for flag, name in (
        (args.ref, "reference"), (args.pore_model, "pore model"),
        (args.ref_index, "reference index"), (args.sig_dir, "signal data"),
        (args.output, "output"),
    ):
        if not flag:
            print(f"No {name} specified!", file=sys.stderr)
            return 1
    cfg = make_config(args)
    t0 = time.time()
    import os

    if os.path.exists(args.ref_index + ".sidx.npz") or args.ref_index.endswith(
        (".sidx", ".npz")
    ):
        idx = SignalIndex.load(args.ref_index)
    elif os.path.exists(args.ref_index + ".pt") or args.ref_index.endswith(".pt"):
        # reference-compatible .pt point cloud: rebuild the grid on the fly
        # (README.md:19 semantics)
        from .io.fasta import read_fasta

        seqs = read_fasta(args.ref)
        pt = (
            args.ref_index
            if args.ref_index.endswith(".pt")
            else args.ref_index + ".pt"
        )
        idx = SignalIndex.load_pt(
            pt, cfg.index, cfg.mapping.search_radius,
            [s.name for s in seqs], [s.length for s in seqs],
        )
    else:
        idx = SignalIndex.load(args.ref_index)
    signals = load_all_read_signals(
        args.sig_dir, cfg.mapping.pa_lo, cfg.mapping.pa_hi
    )
    print(f"Loaded {len(signals)} reads.", file=sys.stderr)
    # engine dispatch (the reference's -m always streams, sigmap.cc:1456-1504;
    # batch mode mirrors the compiled-but-not-dispatched Sigmap::Map)
    if args.batch_mode:
        from .mapping.driver import Mapper

        records = Mapper(idx, cfg).map_reads(signals)
    elif args.engine == "exact":
        from .mapping.driver import Mapper

        records = Mapper(idx, cfg).streaming_map(signals)
    else:
        from .mapping.turbo import TurboMapper

        records = TurboMapper(idx, cfg).streaming_map(signals)
    writer = PAFWriter(args.output, idx.ref_names, idx.ref_lengths)
    for rec in records:
        writer.append(rec)
    n = writer.finalize()
    print(
        f"Finished mapping in {time.time()-t0:.1f}s, "
        f"# reads: {len(signals)}, # records: {n}",
        file=sys.stderr,
    )
    return 0


def run_debug_mode(args) -> int:
    from . import debug_modes

    if args.debug_mode == "fast5-to-text":
        path = debug_modes.fast5_to_text(args.sig_dir, args.output)
    elif args.debug_mode == "events-to-text":
        path = debug_modes.events_to_text(
            args.sig_dir, args.output, make_config(args)
        )
    elif args.debug_mode == "dtw-align":
        debug_modes.dtw_align(args.ref, args.pore_model, args.sig_dir)
        path = "(stderr)"
    else:
        debug_modes.cwt_align(args.ref, args.pore_model, args.sig_dir)
        path = "(stderr)"
    print(f"debug mode {args.debug_mode} -> {path}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug_mode:
        return run_debug_mode(args)
    if args.build_index:
        return run_index(args)
    if args.map:
        return run_map(args)
    build_parser().print_help(sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
