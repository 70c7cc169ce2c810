"""Multi-host orchestration helpers.

The reference is single-process (OpenMP threads, sigmap.cc:618).  Scaling
across hosts follows the standard JAX recipe:

* `jax.distributed.initialize()` on every host (controller-less);
* the global mesh spans all hosts' devices: ("data", "index") as in
  parallel/turbo_shard.py — collectives within a host ride its device
  links (NVLink), across hosts the network;
* read I/O stays host-local: each host loads its own shard of the signal
  directory (mirroring the per-thread buffers of sigmap.cc:217-241) and
  feeds its local data-parallel rows of the global batch;
* per-host PAF partials are concatenated rank-major at the end (the
  reference's MoveMappingsInBuffersToMappingContainer merge, but across
  hosts).

This module cannot be integration-tested in the single-host build
environment; the mesh/sharding logic it feeds is exercised on a virtual
8-device mesh in tests/test_parallel.py and by __graft_entry__.
dryrun_multichip.
"""

from __future__ import annotations

import os

import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """jax.distributed.initialize with env fallbacks; returns
    (process_id, num_processes)."""
    import jax

    kw = {}
    if coordinator_address:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if kw or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(**kw)
    return jax.process_index(), jax.process_count()


def shard_files_for_host(paths: list[str], process_id: int,
                         num_processes: int) -> list[str]:
    """Deterministic round-robin file sharding (host-local I/O)."""
    return [p for i, p in enumerate(sorted(paths)) if i % num_processes == process_id]


def merge_host_paf(partial_paths: list[str], out_path: str) -> int:
    """Concatenate per-host PAF partials rank-major (the cross-host analog
    of the reference's thread-buffer merge, sigmap.cc:217-241)."""
    n = 0
    with open(out_path, "w") as out:
        for p in sorted(partial_paths):
            with open(p) as f:
                for line in f:
                    out.write(line)
                    n += 1
    return n


def global_read_batch(local_chunks: np.ndarray, mesh):
    """Place a host-local chunk batch as this host's rows of the global
    data-parallel batch (jax.make_array_from_process_local_data)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data"))
    return jax.make_array_from_process_local_data(sharding, local_chunks)
