"""Worker for the 2-process multi-host test (run by test_multihost.py).

Each process: jax.distributed.initialize -> global ("data", "index") mesh
spanning both processes' CPU devices -> TurboShardMapper over the global
mesh -> write THIS host's shard of the PAF records to a partial file.
Rank 0 then merges partials (multihost.merge_host_paf) — the cross-host
analogue of the reference's per-thread output-buffer merge
(sigmap.cc:217-241).

Inputs are deterministic (same synthetic workload on every process), so
the global device_put calls see identical host values — the documented
contract for feeding the global batch (a production deployment would use
make_array_from_process_local_data with host-local read shards instead;
multihost.global_read_batch wraps that).

Usage: python multihost_worker.py RANK NPROCS COORD OUTDIR
"""

import os
import sys

rank = int(sys.argv[1])
nprocs = int(sys.argv[2])
coord = sys.argv[3]
outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = [
    f for f in os.environ.get("XLA_FLAGS", "").split()
    if "xla_force_host_platform_device_count" not in f
]
os.environ["XLA_FLAGS"] = " ".join(
    flags + ["--xla_force_host_platform_device_count=4"]
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sigmap_tpu.parallel.multihost import initialize_distributed  # noqa: E402

initialize_distributed(coord, nprocs, rank)

import time  # noqa: E402

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import dataclasses  # noqa: E402

from sigmap_tpu.config import SigmapConfig  # noqa: E402
from sigmap_tpu.index.build import build_index  # noqa: E402
from sigmap_tpu.io.fasta import ReferenceSequence  # noqa: E402
from sigmap_tpu.io.paf import mapped_line, unmapped_line  # noqa: E402
from sigmap_tpu.io.pore_model import make_synthetic_pore_model  # noqa: E402
from sigmap_tpu.io.signals import ReadSignal, dac_to_pa  # noqa: E402
from sigmap_tpu.mapping.turbo import TurboParams  # noqa: E402
from sigmap_tpu.parallel.turbo_shard import TurboShardMapper  # noqa: E402
from sigmap_tpu.synth import random_genome, simulate_reads  # noqa: E402

assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == 4 * nprocs

cfg = SigmapConfig()
pore = make_synthetic_pore_model(k=6, seed=0)
genome = random_genome(80_000, seed=21)
seqs = [ReferenceSequence(n, c) for n, c in genome]
idx = build_index(seqs, pore, cfg.index, cfg.mapping.search_radius,
                  verbose=False)
reads = simulate_reads(pore, genome, 8, seed=6, read_bases=2200)
signals = [
    ReadSignal(r.read_id, r.digitisation, r.range, r.offset,
               dac_to_pa(r.raw, r.digitisation, r.range, r.offset))
    for r in reads
]
cfg = dataclasses.replace(
    cfg, runtime=dataclasses.replace(cfg.runtime, read_batch=8)
)
mesh = Mesh(
    np.array(jax.devices()).reshape(4 * nprocs // 2, 2), ("data", "index")
)
p = TurboParams(S=256, K=32, RING=64, TILE=256)
tm = TurboShardMapper(idx, cfg, mesh, p)
t0 = time.perf_counter()
records = tm.streaming_map(signals)
elapsed = time.perf_counter() - t0
assert len(records) == len(signals), (len(records), len(signals))

# each host writes ITS contiguous shard of reads (host-local output)
lo = rank * len(records) // nprocs
hi = (rank + 1) * len(records) // nprocs
part = os.path.join(outdir, f"part_{rank:03d}.paf")
with open(part, "w") as f:
    for rec in records[lo:hi]:
        if rec.is_mapped:
            line = mapped_line(rec, idx.ref_names[rec.ref_index],
                               idx.ref_lengths[rec.ref_index])
        else:
            line = unmapped_line(rec)
        # strip wall-clock tag for determinism
        line = "\t".join(x for x in line.strip().split("\t")
                         if not x.startswith("mt:"))
        f.write(line + "\n")
print(f"rank {rank}: mapped "
      f"{sum(r.is_mapped for r in records)}/{len(records)} "
      f"in {elapsed:.2f}s", flush=True)

if rank == 0:
    # wait for all partials, then merge rank-major
    from sigmap_tpu.parallel.multihost import merge_host_paf

    parts = [os.path.join(outdir, f"part_{i:03d}.paf")
             for i in range(nprocs)]
    deadline = time.time() + 120
    while time.time() < deadline:
        if all(os.path.exists(pth) for pth in parts):
            break
        time.sleep(0.2)
    # partials are complete once every worker has passed its barrier below
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("paf_partials")
    n = merge_host_paf(parts, os.path.join(outdir, "merged.paf"))
    print(f"rank 0: merged {n} records", flush=True)
else:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("paf_partials")
