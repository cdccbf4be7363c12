"""The port's verify tool (``tools/verify_cuda.py``) on the CPU, and a
whole-file diff of the port's output against the JAX package's ``JaxPlacer``
(through each package's ``place`` command) over a FASTA that mixes 150 bp
reads with 2-10 kb long reads, at the acceptance rule of
``tools/jplace_diff.py`` (1e-4 in probability space)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from epik_tpu.cli.main import place_queries as jax_place_queries
from epik_tpu.io.build import reads_from_reference, reference_like_db
from epik_tpu.io.db import save
from epik_tpu.tools.jplace_diff import jplace_diff, parse_jplace

from epik_tpu_torch.cli.main import main

REPO = Path(__file__).resolve().parents[1]


def test_verify_tool_on_the_cpu(tmp_path):
    """One JSON line on stdout, every built-in case and every engine's mixed
    reads matching the oracle."""
    out = subprocess.run([sys.executable, "-m", "epik_tpu_torch.tools.verify_cuda",
                          "--platform", "cpu", "--workdir", str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["verify"] == "cuda" and got["backend"] == "cpu" and got["ok"] is True
    assert got["cases_passed"] == got["cases_total"] == 4
    assert got["reads_matched"] == got["reads_total"] == 8 * 295
    assert sorted(got["mixed"]) == sorted([
        "torch", "torch_classic", "torch_int16", "torch_tiles", "sharded_1x1",
        "sharded_tiles_1x1", "torch_amino", "torch_amino_pair"])


def test_verify_tool_never_falls_back_to_the_cpu(tmp_path):
    """Without a card, the default platform raises instead of placing on the
    CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "epik_tpu_torch.tools.verify_cuda",
                          "--workdir", str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.fixture(scope="module")
def long_read_fixture(tmp_path_factory):
    """A 40-leaf k=8 database, and a FASTA of 200 150 bp reads with twelve
    long reads of 2-10 kb among them (one with an IUPAC code), placed by the
    JAX package's CLI (``engine="jax"``, the ``JaxPlacer``)."""
    d = tmp_path_factory.mktemp("torch_verify")
    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=81)
    save(db, d / "DB.eptk")
    short = reads_from_reference(ref, 200, length=150, mutation_rate=0.03, seed=82)
    long_reads = [(f"long_{i}", seq) for i, (_, seq) in enumerate(reads_from_reference(
        ref, 12, mutation_rate=0.03, seed=83, length_range=(2_000, 10_000)))]
    assert all(2_000 <= len(seq) <= 10_000 for _, seq in long_reads)
    name, seq = long_reads[3]
    long_reads[3] = (name, seq[:500] + b"N" + seq[501:])
    records = short[:100] + long_reads[:6] + short[100:] + long_reads[6:]
    with open(d / "q.fasta", "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq.decode()}\n")
    (d / "jax").mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(d / "jax"), 1, "",
                             str(d / "q.fasta"), batch_size=64, engine="jax") == 0
    return d, [name for name, _ in records]


@pytest.mark.parametrize("engine", ["torch", "classic", "sharded", "tiles"])
def test_long_reads_whole_file_match_jax(long_read_fixture, monkeypatch, capsys, engine):
    """The port's jplace of the mixed-length FASTA against JaxPlacer's, whole
    file, both ways, within 1e-4: the dense plane (shifted, classic), the
    column-sharded plane (1 x 2 on the CPU) and the tiles route (a budget
    that holds the posting tiles but not the plane; the long reads go to the
    CSR step)."""
    d, names = long_read_fixture
    extra = {"torch": [], "classic": ["--plane-mode", "classic"],
             "sharded": ["--engine", "sharded", "--n-model", "2"], "tiles": []}[engine]
    if engine == "tiles":
        from epik_tpu.io.db import load

        from epik_tpu_torch.engine import placer
        from epik_tpu_torch.engine.tiles import tile_bytes

        db = load(str(d / "DB.eptk"), mu=1.0, user_omega=1.5)
        budget = tile_bytes(db.num_kmers, int(np.diff(db.row_off).max()))
        monkeypatch.setattr(placer, "device_budget", lambda device: budget)
    out = d / engine
    out.mkdir()
    assert main(["place", "-i", str(d / "DB.eptk"), "-o", str(out), "--platform", "cpu",
                 "--batch-size", "64", *extra, str(d / "q.fasta")]) == 0
    route = {"torch": "dense)", "classic": "dense)", "sharded": "1x2 (dense)",
             "tiles": "tiles)"}[engine]
    assert route in capsys.readouterr().out
    port_jp = out / "placements_q.fasta.jplace"
    jax_jp = d / "jax" / "placements_q.fasta.jplace"
    assert set(parse_jplace(str(port_jp))) == set(parse_jplace(str(jax_jp))) == set(names)
    for a, b in ((port_jp, jax_jp), (jax_jp, port_jp)):
        res = jplace_diff(str(a), str(b))
        assert res.clean and res.num_seqs == len(names), res.mismatches[:5]
