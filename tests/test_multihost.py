"""Real 2-process multi-host test: jax.distributed over local CPU procs.

Spawns two Python processes that each initialize jax.distributed (4 CPU
devices per process), build a global ("data" x "index") mesh spanning
both, run the sharded turbo engine on the same workload, write per-host
PAF partials, and merge them rank-major (multihost.merge_host_paf).  The
merged output must equal the single-process TurboMapper's records — the
multi-host analogue of tests/test_turbo_shard.py's single-host equality.

Reference analogue: OpenMP taskloop fan-out + per-thread output buffer
merge, /root/reference/src/sigmap.cc:618-631,217-241.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_turbo_shard(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), "2", coord, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"

    merged = tmp_path / "merged.paf"
    assert merged.exists()
    lines = merged.read_text().splitlines()
    assert len(lines) == 8

    # single-process expected output on the same deterministic workload
    import dataclasses

    import numpy as np

    from sigmap_tpu.config import SigmapConfig
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import ReferenceSequence
    from sigmap_tpu.io.paf import mapped_line, unmapped_line
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model
    from sigmap_tpu.io.signals import ReadSignal, dac_to_pa
    from sigmap_tpu.mapping.turbo import TurboMapper, TurboParams
    from sigmap_tpu.synth import random_genome, simulate_reads

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
    p = TurboParams(S=256, K=32, RING=64, TILE=256)
    records = TurboMapper(idx, cfg, p).streaming_map(signals)
    want = []
    for rec in sorted(records, key=lambda r: r.read_id):
        line = (
            mapped_line(rec, idx.ref_names[rec.ref_index],
                        idx.ref_lengths[rec.ref_index])
            if rec.is_mapped else unmapped_line(rec)
        )
        want.append("\t".join(x for x in line.strip().split("\t")
                              if not x.startswith("mt:")))
    assert lines == want
    assert sum("\t+\t" in l or "\t-\t" in l for l in lines) >= 7
