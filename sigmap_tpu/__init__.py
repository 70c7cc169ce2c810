"""sigmap_tpu: a JAX (XLA/Pallas-Triton) raw nanopore signal mapper.

Built from scratch with the capabilities of haowenz/sigmap (Zhang et al.,
Bioinformatics 2021): streaming mapping of raw ONT current signal to
reference genomes via a pore-model signal index, event detection, seed
radius-search and minimap2-style chaining, emitting Uncalled-style PAF.

Architecture (device-first, not a port):
  * host layer: FASTA / pore-model / fast5 / blow5 I/O, PAF emission;
  * device layer: batched event detection, grid-bucketed seed search over an
    device-resident reference point cloud, banded chaining, wavefront sDTW —
    all JAX/Pallas with static shapes;
  * native layer: C++ exact-semantics engine (golden oracle, CPU baseline,
    host-exact chainer) bound via ctypes;
  * parallel layer: shard_map over a ("data","index") mesh.
"""

from .config import DEFAULT_CONFIG, SigmapConfig

__version__ = "0.1.0"
__all__ = ["DEFAULT_CONFIG", "SigmapConfig", "__version__"]
