"""The port's CLI (``python -m epik_tpu_torch place``) on the CPU against the
JAX package's ``place_queries(engine="jax")``: the two jplace files hold the
same read names and ``tools/jplace_diff`` finds them equal at 1e-4. The
``--engine sharded`` run against the JAX CLI's ``engine="sharded"``, and the
``native`` and ``reference`` engines against the JAX CLI's oracle run."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from epik_tpu.cli.main import place_queries as jax_place_queries
from epik_tpu.io.build import reads_from_reference, reference_like_db
from epik_tpu.io.db import save
from epik_tpu.tools.jplace_diff import jplace_diff, parse_jplace

from epik_tpu_torch.cli.main import main, make_invocation, make_output_filename


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=20_000,
                                mean_posting_len=6.0, seed=41)
    save(db, d / "DB.eptk")
    reads = reads_from_reference(ref, 70, length=101, mutation_rate=0.05, seed=42)
    reads[5] = ("amb", reads[5][1][:30] + b"N" + reads[5][1][31:])
    reads[9] = ("short", b"ACG")
    reads[12] = ("dup", reads[11][1])
    with open(d / "q.fasta", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    return d, [name for name, _ in reads]


def _run_port(d, out, *extra):
    out.mkdir(exist_ok=True)
    return main(["place", "-i", str(d / "DB.eptk"), "-o", str(out), "--platform", "cpu",
                 "--inflight", "3", "--batch-size", "32", *extra, str(d / "q.fasta")])


def test_cli_matches_jax_cli(fixture_dir, capsys):
    d, names = fixture_dir
    assert _run_port(d, d / "port") == 0
    text = capsys.readouterr().out
    assert "Placed 70 sequences." in text and "Engine: torch/cpu" in text
    (d / "jax").mkdir()
    rc = jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(d / "jax"), 1, "",
                           str(d / "q.fasta"), batch_size=32, engine="jax")
    assert rc == 0
    port_jp = d / "port" / "placements_q.fasta.jplace"
    jax_jp = d / "jax" / "placements_q.fasta.jplace"
    assert json.loads(port_jp.read_text())["version"] == 3
    assert set(parse_jplace(str(port_jp))) == set(parse_jplace(str(jax_jp))) == set(names)
    for a, b in ((port_jp, jax_jp), (jax_jp, port_jp)):
        res = jplace_diff(str(a), str(b))
        assert res.clean, res.mismatches[:5]


@pytest.mark.parametrize("payload", ["packed", "f32"])
def test_cli_tiles_route_matches_jax_cli(fixture_dir, capsys, monkeypatch, payload):
    """A device whose memory holds the posting tiles but not the dense plane:
    the CLI places through the tiles route (the IUPAC and short reads through
    CSR) with either ``--tile-payload``, and matches the JAX CLI."""
    import numpy as np

    from epik_tpu.io.db import load
    from epik_tpu_torch.engine import placer
    from epik_tpu_torch.engine.tiles import tile_bytes

    d, names = fixture_dir
    db = load(str(d / "DB.eptk"), mu=1.0, user_omega=1.5)
    budget = tile_bytes(db.num_kmers, int(np.diff(db.row_off).max()))
    monkeypatch.setattr(placer, "device_budget", lambda device: budget)
    assert _run_port(d, d / f"tiles_{payload}", "--tile-payload", payload) == 0
    assert "(1 device(s), tiles)" in capsys.readouterr().out
    port_jp = d / f"tiles_{payload}" / "placements_q.fasta.jplace"
    jax_jp = d / f"jax_{payload}" / "placements_q.fasta.jplace"
    jax_jp.parent.mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(jax_jp.parent), 1,
                             "", str(d / "q.fasta"), batch_size=32, engine="jax") == 0
    assert set(parse_jplace(str(port_jp))) == set(names)
    for a, b in ((port_jp, jax_jp), (jax_jp, port_jp)):
        res = jplace_diff(str(a), str(b))
        assert res.clean, res.mismatches[:5]


def test_cli_errors(fixture_dir, capsys):
    """Bad flags end the run with -1; ``--precision int16`` (the int16
    plane) places and matches the JAX CLI with the same flag."""
    d, names = fixture_dir
    assert _run_port(d, d / "bad_mu", "--mu", "1.5") == -1
    assert _run_port(d, d / "bad_states", "-s", "amino") == -1
    assert "Error:" in capsys.readouterr().err
    assert _run_port(d, d / "int16", "--precision", "int16") == 0
    assert "(1 device(s), dense)" in capsys.readouterr().out
    (d / "jax_int16").mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(d / "jax_int16"), 1,
                             "", str(d / "q.fasta"), batch_size=32, engine="jax",
                             precision="int16") == 0
    port_jp = d / "int16" / "placements_q.fasta.jplace"
    jax_jp = d / "jax_int16" / "placements_q.fasta.jplace"
    assert set(parse_jplace(str(port_jp))) == set(names)
    for a, b in ((port_jp, jax_jp), (jax_jp, port_jp)):
        res = jplace_diff(str(a), str(b))
        assert res.clean, res.mismatches[:5]


def _same_jplace(a, b, names):
    assert set(parse_jplace(str(a))) == set(parse_jplace(str(b))) == set(names)
    for x, y in ((a, b), (b, a)):
        res = jplace_diff(str(x), str(y))
        assert res.clean, res.mismatches[:5]


@pytest.fixture(scope="module")
def oracle_jplace(fixture_dir):
    """The JAX CLI's ``engine="reference"`` run (the scalar oracle)."""
    d, _ = fixture_dir
    out = d / "jax_reference"
    out.mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(out), 1, "",
                             str(d / "q.fasta"), batch_size=32, engine="reference") == 0
    return out / "placements_q.fasta.jplace"


def test_cli_engine_sharded_matches_jax_cli(fixture_dir, oracle_jplace, capsys):
    """``--engine sharded --n-model 2 --platform cpu``: a 1x2 mesh over the
    repeated CPU device on the column-sharded dense route, against the JAX
    CLI's sharded engine (a 4x2 mesh of the 8 virtual devices) and the
    oracle."""
    d, names = fixture_dir
    assert _run_port(d, d / "sharded", "--engine", "sharded", "--n-model", "2") == 0
    assert "Engine: torch/cpu sharded mesh 1x2 (dense)" in capsys.readouterr().out
    (d / "jax_sharded").mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(d / "jax_sharded"), 1,
                             "", str(d / "q.fasta"), batch_size=32, engine="sharded",
                             n_model=2) == 0
    port_jp = d / "sharded" / "placements_q.fasta.jplace"
    _same_jplace(port_jp, d / "jax_sharded" / "placements_q.fasta.jplace", names)
    _same_jplace(port_jp, oracle_jplace, names)


@pytest.mark.parametrize("engine,line", [("native", "Engine: native C++ scalar (-j 1)"),
                                         ("reference", "Engine: scalar (oracle)")])
def test_cli_cpu_engines_match_oracle(fixture_dir, oracle_jplace, capsys, engine, line):
    d, names = fixture_dir
    assert _run_port(d, d / engine, "--engine", engine) == 0
    assert line in capsys.readouterr().out
    _same_jplace(d / engine / "placements_q.fasta.jplace", oracle_jplace, names)


def test_helpers():
    assert make_invocation(["epik", "place", "-i", "db"]) == "epik place -i db "
    assert make_output_filename("/x/y/reads.fasta", "/out") == "/out/placements_reads.fasta.jplace"


def test_module_entry_point_help():
    """``python -m epik_tpu_torch place --help`` needs neither jax nor click."""
    out = subprocess.run([sys.executable, "-m", "epik_tpu_torch", "place", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    for flag in ("--database", "--batch-size", "--platform", "--pair-plane", "--resume",
                 "--tile-payload", "--engine", "--n-model"):
        assert flag in out.stdout
