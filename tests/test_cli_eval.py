"""CLI end-to-end (index + map via the library entry point) and evaluation."""

import subprocess
import sys

import numpy as np
import pytest

from sigmap_tpu.evaluate import evaluate_against_truth, evaluate_annotated_paf
from sigmap_tpu.io.fasta import write_fasta
from sigmap_tpu.io.fast5 import write_multi_fast5
from sigmap_tpu.synth import genome_to_fasta_str, random_genome, simulate_reads
from sigmap_tpu.utils import CODE_TO_CHAR


@pytest.fixture(scope="module")
def workload(tmp_path_factory, pore6):
    d = tmp_path_factory.mktemp("cli")
    genome = random_genome(60_000, seed=13)
    (d / "ref.fa").write_text(genome_to_fasta_str(genome))
    pore6.save(str(d / "pore.model"))
    reads = simulate_reads(pore6, genome, 6, seed=14, read_bases=1200)
    sig = d / "sigs"
    sig.mkdir()
    write_multi_fast5(str(sig / "batch.fast5"), [r.__dict__ for r in reads])
    return d, reads


def _run_cli(args):
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "sigmap_tpu.cli", *args],
        capture_output=True, text=True, env=env, timeout=600,
    )


def test_cli_index_and_map(workload):
    d, reads = workload
    r = _run_cli(
        ["-i", "-r", str(d / "ref.fa"), "-p", str(d / "pore.model"),
         "-o", str(d / "idx")]
    )
    assert r.returncode == 0, r.stderr
    assert (d / "idx.sidx.npz").exists()
    assert (d / "idx.pt").exists()

    r = _run_cli(
        ["-m", "-r", str(d / "ref.fa"), "-p", str(d / "pore.model"),
         "-x", str(d / "idx"), "-s", str(d / "sigs"),
         "-o", str(d / "out.paf"), "--read-batch", "8"]
    )
    assert r.returncode == 0, r.stderr
    lines = (d / "out.paf").read_text().splitlines()
    assert len(lines) == len(reads)
    mapped = [l for l in lines if "\t+\t" in l or "\t-\t" in l]
    assert len(mapped) >= len(reads) // 2
    cols = mapped[0].split("\t")
    assert len(cols) >= 13 and cols[4] in "+-"


def test_evaluate_against_truth(workload, pore6):
    from sigmap_tpu.config import RuntimeConfig, SigmapConfig
    from sigmap_tpu.index.build import build_index
    from sigmap_tpu.io.fasta import read_fasta
    from sigmap_tpu.io.signals import load_all_read_signals
    from sigmap_tpu.mapping.driver import Mapper

    d, reads = workload
    cfg = SigmapConfig(
        runtime=RuntimeConfig(
            read_batch=8, seeds_per_tile=32, cap_per_seed=8192,
            surv_per_tile=65536, matches_per_tile=16384,
        )
    )
    idx = build_index(read_fasta(str(d / "ref.fa")), pore6, cfg.index,
                      verbose=False)
    signals = load_all_read_signals(str(d / "sigs"))
    order = {r.read_id: r for r in reads}
    recs = Mapper(idx, cfg).streaming_map(signals)
    res = evaluate_against_truth(recs, [order[s.read_id] for s in signals])
    assert res.fp == 0
    assert res.tp >= len(reads) // 2
    assert res.time_per_read


def test_evaluate_annotated_paf(tmp_path):
    paf = tmp_path / "a.paf"
    paf.write_text(
        "r1\t100\t0\t50\t+\tc\t1000\t10\t60\t100\t51\t60\t"
        "mt:f:5.0\tci:i:2\tsl:i:100\tkl:Z:tp\n"
        "r2\t100\t*\t*\t*\t*\t*\t*\t*\t*\t*\t61\tmt:f:1.0\tci:i:1\tkl:Z:fn\n"
    )
    res = evaluate_annotated_paf(str(paf))
    assert res.tp == 1 and res.fn == 1
    assert res.precision == 1.0 and res.recall == 0.5
