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


def _counting(monkeypatch, module, names):
    """Wrap ``module``'s kernel wrappers ``names`` to count their calls (the
    plain versions on the CPU count no launches)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("precision", ["exact", "int16"])
def test_cli_gather_and_finish_apart_match_jax_cli(fixture_dir, capsys, monkeypatch,
                                                   precision):
    """The shifted dense route past the fused kernel's limit (``topk_fits``
    refusing, as it does on the card at B = 39,999): every batch runs the
    gather alone (1d, ``rowgather_sum``) and ``finish_topk`` apart; the
    jplace matches the JAX CLI's with the same flags."""
    from epik_tpu_torch.engine import step

    d, names = fixture_dir
    monkeypatch.setattr(step, "topk_fits", lambda plane, B, K: False)
    calls = _counting(monkeypatch, step, ["rowgather_sum", "finish_topk"])
    out = d / f"apart_{precision}"
    assert _run_port(d, out, "--precision", precision) == 0
    assert "(1 device(s), dense)" in capsys.readouterr().out
    n_batches = -(-len(names) // 32)
    assert calls == {"rowgather_sum": n_batches, "finish_topk": n_batches}
    jax_out = d / f"jax_apart_{precision}"
    jax_out.mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(jax_out), 1, "",
                             str(d / "q.fasta"), batch_size=32, engine="jax",
                             precision=precision) == 0
    _same_jplace(out / "placements_q.fasta.jplace", jax_out / "placements_q.fasta.jplace",
                 names)


def test_cli_sharded_classic_past_the_fused_limit_matches_jax_cli(fixture_dir, capsys,
                                                                  monkeypatch):
    """``--engine sharded --plane-mode classic`` on a 1x1 mesh with the fused
    counts kernel refusing the shard (``counts_cols_fits``, as it does on the
    card past bwl 22,064): every batch runs the gather with counts and kernel
    A's counts form (``finish_cols_partial_counts``) apart; the jplace
    matches the JAX CLI's sharded classic run."""
    from epik_tpu_torch.parallel import sharding

    d, names = fixture_dir
    monkeypatch.setattr(sharding, "counts_cols_fits", lambda plane, K: False)
    calls = _counting(monkeypatch, sharding, ["rowgather_sum_counts",
                                              "finish_cols_partial_counts"])
    out = d / "sharded_classic_apart"
    assert _run_port(d, out, "--engine", "sharded", "--plane-mode", "classic") == 0
    assert "Engine: torch/cpu sharded mesh 1x1 (dense)" in capsys.readouterr().out
    n_batches = -(-len(names) // 32)
    assert calls == {"rowgather_sum_counts": n_batches,
                     "finish_cols_partial_counts": n_batches}
    jax_out = d / "jax_sharded_classic"
    jax_out.mkdir()
    assert jax_place_queries(str(d / "DB.eptk"), "nucl", 1.5, 1.0, str(jax_out), 1, "",
                             str(d / "q.fasta"), batch_size=32, engine="sharded", n_model=1,
                             plane_mode="classic") == 0
    _same_jplace(out / "placements_q.fasta.jplace", jax_out / "placements_q.fasta.jplace",
                 names)


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
