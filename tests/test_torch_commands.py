"""The port's commands other than ``place`` (``diff``, ``probe``, ``convert``,
``stats``, ``build-db``, ``ppdiff``) against the JAX CLI's, run through
click's ``CliRunner`` on the same seeded fixture: the same stdout, the same
files byte for byte, the same exit codes. Also ``place --profile-dir`` on the
CPU, and ``python -m epik_tpu_torch <command>`` for every command."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from epik_tpu.cli.main import epik
from epik_tpu.io.build import random_db
from epik_tpu.io.db import save

from epik_tpu_torch.cli.main import main

REPO = Path(__file__).resolve().parents[1]
COMMANDS = ["place", "diff", "probe", "convert", "stats", "build-db", "ppdiff"]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from epik_tpu.core.alphabet import DNA

    d = tmp_path_factory.mktemp("torch_commands")
    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=77)
    save(db, d / "DB.eptk")
    rng = np.random.default_rng(5)
    with open(d / "q.fasta", "w") as f:
        for i in range(30):
            parts = [DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                     for _ in range(5)]
            f.write(f">q{i}\n{''.join(parts)}\n")
    return d


def _jax(args):
    return CliRunner().invoke(epik, [str(a) for a in args])


def _port(capsys, args):
    rc = main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_stats_matches_jax(fixture_dir, capsys):
    want = _jax(["stats", fixture_dir / "DB.eptk"])
    rc, out, _ = _port(capsys, ["stats", fixture_dir / "DB.eptk"])
    assert want.exit_code == 0 and rc == 0
    assert out == want.stdout and "k-mers: 1024" in out


def test_convert_files_byte_equal(fixture_dir, tmp_path, capsys):
    """.eptk -> .ipk -> .eptk through each CLI: the same bytes at each step,
    the same stdout, and the round trip returns the first file's bytes."""
    src = fixture_dir / "DB.eptk"
    for step, (a, b) in enumerate(((src, "db.ipk"), ("db.ipk", "back.eptk"))):
        a_j = a if step == 0 else tmp_path / "jax" / a
        a_p = a if step == 0 else tmp_path / "port" / a
        (tmp_path / "jax").mkdir(exist_ok=True)
        (tmp_path / "port").mkdir(exist_ok=True)
        want = _jax(["convert", a_j, tmp_path / "jax" / b])
        rc, out, _ = _port(capsys, ["convert", a_p, tmp_path / "port" / b])
        assert want.exit_code == 0 and rc == 0
        assert out == want.stdout.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        assert (tmp_path / "port" / b).read_bytes() == (tmp_path / "jax" / b).read_bytes()
    assert (tmp_path / "port" / "back.eptk").read_bytes() == src.read_bytes()


def test_convert_unverified_ipk_exits_1(tmp_path, capsys):
    """A file the reconstructed .ipk layout cannot read: exit code 1 and the
    same two stderr lines."""
    bad = tmp_path / "bad.ipk"
    bad.write_bytes(b"\x16\x00\x00\x00\x00\x00\x00\x00serialization::archive" + bytes(64))
    want = _jax(["convert", bad, tmp_path / "a.eptk"])
    rc, out, err = _port(capsys, ["convert", bad, tmp_path / "b.eptk"])
    assert want.exit_code == 1 and rc == 1 and out == ""
    assert err == want.stderr and len(err.splitlines()) == 2
    assert err.startswith(f"Error reading {bad}:")


def test_probe_matches_jax(fixture_dir, tmp_path, capsys):
    ipk = tmp_path / "db.ipk"
    assert _jax(["convert", fixture_dir / "DB.eptk", ipk]).exit_code == 0
    want = _jax(["probe", ipk])
    rc, out, _ = _port(capsys, ["probe", ipk])
    assert want.exit_code == 0 and rc == 0
    assert out == want.stdout and "landmark 'nucl'" in out


def test_build_db_byte_equal(tmp_path, capsys):
    (tmp_path / "tree.nwk").write_text("((A:0.1,B:0.2):0.3,C:0.4):0.0;")
    (tmp_path / "entries.json").write_text(json.dumps(
        {"ACG": [[0, -1.0], [2, -2.0]], "CGT": [[1, -0.5]], "TTA": [[3, -0.25]]}))
    args = ["build-db", "--tree", tmp_path / "tree.nwk", "--entries",
            tmp_path / "entries.json", "-k", "3", "--omega", "2.0"]
    want = _jax(args + [tmp_path / "jax.eptk"])
    rc, out, _ = _port(capsys, args + [tmp_path / "port.eptk"])
    assert want.exit_code == 0 and rc == 0
    assert out == want.stdout.replace("jax.eptk", "port.eptk")
    assert (tmp_path / "port.eptk").read_bytes() == (tmp_path / "jax.eptk").read_bytes()


@pytest.fixture(scope="module")
def jplaces(fixture_dir):
    """A jplace of the fixture placed by the port on the CPU, and a copy with
    one likelihood moved and one read's placements dropped."""
    out = fixture_dir / "placed"
    out.mkdir()
    assert main(["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out),
                 "--platform", "cpu", str(fixture_dir / "q.fasta")]) == 0
    clean = out / "placements_q.fasta.jplace"
    doc = json.loads(clean.read_text())
    fields = doc["fields"]
    doc["placements"][3]["p"][0][fields.index("likelihood")] += 0.5
    del doc["placements"][7]
    differing = fixture_dir / "differing.jplace"
    differing.write_text(json.dumps(doc))
    return clean, differing


@pytest.mark.parametrize("pair", ["clean", "differing"])
def test_diff_matches_jax(jplaces, capsys, pair):
    clean, differing = jplaces
    other = clean if pair == "clean" else differing
    want = _jax(["diff", clean, other])
    rc, out, _ = _port(capsys, ["diff", clean, other])
    assert rc == want.exit_code == (0 if pair == "clean" else 1)
    assert out.splitlines() == want.stdout.splitlines()
    assert ("30/30 placements match." in out) == (pair == "clean")


def test_ppdiff_passing_config(tmp_path, capsys):
    """A config of two engines that need no device gives rc 0 and the JAX
    command's PASS lines (the JAX side diffs the oracle with itself: its
    harness has no native engine)."""
    case = {"name": "tiny", "db": {"num_leaves": 16, "kmer_size": 6, "num_kmers": 1024,
                                   "seed": 3},
            "reads": {"n": 40, "from_db_kmers": True, "parts": 6, "seed": 4}}
    port_cfg, jax_cfg = tmp_path / "port.json", tmp_path / "jax.json"
    port_cfg.write_text(json.dumps({"cases": [dict(case, engines=["reference", "native"])]}))
    jax_cfg.write_text(json.dumps({"cases": [dict(case, engines=["reference", "reference"])]}))
    want = _jax(["ppdiff", "--config", jax_cfg, "--workdir", tmp_path / "jax"])
    rc, out, _ = _port(capsys, ["ppdiff", "--config", port_cfg, "--workdir", tmp_path / "port"])
    assert want.exit_code == 0 and rc == 0
    assert out == want.stdout == "PASS tiny: 40/40 match\n"


def test_ppdiff_broken_engine_raises(tmp_path, capsys):
    cfg = tmp_path / "bad.json"
    cfg.write_text(json.dumps({"cases": [{
        "name": "bad", "db": {"num_leaves": 8, "kmer_size": 4, "num_kmers": 64, "seed": 1},
        "reads": {"n": 4, "seed": 2}, "engines": ["reference", "bogus"]}]}))
    want = _jax(["ppdiff", "--config", cfg, "--workdir", tmp_path / "jax"])
    assert isinstance(want.exception, ValueError) and "bogus" in str(want.exception)
    with pytest.raises(ValueError, match="unknown engine 'bogus'"):
        main(["ppdiff", "--config", str(cfg), "--workdir", str(tmp_path / "port")])


def test_ppdiff_default_cases_on_the_cpu(tmp_path, capsys):
    """The built-in cases through the harness's torch and sharded engines on
    the CPU (the sharded-4x2 mesh repeating the CPU device) all pass."""
    from epik_tpu_torch.tools import ppdiff

    assert ppdiff.main(["--platform", "cpu", "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "PASS nucl-exact", "PASS nucl-ambiguous", "PASS amino", "PASS sharded-4x2"]


def test_place_profile_dir_writes_a_trace(fixture_dir, tmp_path, capsys):
    prof = tmp_path / "prof"
    out = tmp_path / "out"
    out.mkdir()
    assert main(["place", "-i", str(fixture_dir / "DB.eptk"), "-o", str(out), "--platform",
                 "cpu", "--profile-dir", str(prof), str(fixture_dir / "q.fasta")]) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    # the batches' own operations, from the pipeline's worker threads
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::index", "aten::sum"} & ops, sorted(ops)[:20]
    assert (out / "placements_q.fasta.jplace").exists()


@pytest.mark.parametrize("command", COMMANDS)
def test_python_m_reaches_each_command(command):
    out = subprocess.run([sys.executable, "-m", "epik_tpu_torch", command, "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"usage: epik_tpu_torch {command}")


def test_no_flag_the_jax_cli_lacks():
    """Every command's options are among the JAX command's (the port's
    ``--platform`` stands in for JAX's own ``--platform``)."""
    from epik_tpu_torch.cli.main import build_parser

    sub = next(a for a in build_parser()._actions if a.dest == "command")
    assert sorted(sub.choices) == sorted(COMMANDS)
    for name, parser in sub.choices.items():
        ours = {o for a in parser._actions for o in a.option_strings} - {"-h", "--help"}
        theirs = {o for p in epik.commands[name].params for o in p.opts}
        assert ours <= theirs, (name, ours - theirs)
