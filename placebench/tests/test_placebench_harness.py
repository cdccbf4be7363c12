"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped), cells added by files alone, the faults and the control that must
come out as not correct, and the cells on the card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from placebench import harness

REPO = Path(__file__).resolve().parents[2]
TINY_CONFIG = {
    "name": "tiny", "source": "test", "deployment": "a tiny database for the CPU tests",
    "generator": {"num_leaves": 40, "kmer_size": 8, "ref_length": 20000,
                  "mean_posting_len": 12.0, "omega": 1.5},
    "placer": {"keep_at_most": 7, "keep_factor": 0.01,
               "config": {"host_threads": 1, "precision": "exact", "plane_mode": "shifted",
                          "pair_plane": "auto", "tile_payload": "auto"}},
    "route": "dense", "assumed": [], "reduced": []}
TINY_TRAFFIC = {"lengths": [100, 300], "divergence": 0.02, "iupac_share": 0.02,
                "iupac_per_read": [1, 2], "batch": 100, "inflight": 3, "pool_batches": 4,
                "warmup_batches": 2, "check": {"batches": 4, "reads": 20}}
#: the tiny cell's limits, set as the cells' are: exact runs read ll_gap
#: 7.6e-6 - 1.53e-5 and lwr_gap 7.4e-6 - 9.2e-6 over 12 seeds (900-911, 0.5 s
#: windows), the bf16 control 7.1e-3 - 1.04e-2 and 3.8e-3 - 4.6e-3 on 3 seeds
TINY_LIMITS = {"lost_reads": 0, "missing": 0, "length_gap": 0.0, "ll_gap": 2e-4,
               "lwr_gap": 1.5e-4}


def make_root(tmp: Path, workload: str = "tiny.short") -> Path:
    """A checkout with the benchmark's folder and a BENCHMARK.json of one
    tiny cell."""
    shutil.copytree(REPO / "placebench", tmp / "placebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    folder = tmp / "placebench"
    (folder / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (folder / "traffic" / "short.json").write_text(json.dumps(TINY_TRAFFIC))
    (folder / "cells" / f"{workload}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "placebench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": workload, "config": "tiny", "traffic": "short", "chips": 1,
                           "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [workload]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root, seed=12345, seconds=1.0, traced=False, **kw):
    return harness.run_cell(root, "tiny.short", seed, seconds, traced, device="cpu",
                            log=lambda line: None, **kw)


def test_whole_run_on_the_cpu(tmp_path):
    root = make_root(tmp_path)
    r = run(root, seed=2**31 + 11)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    # no card: the card's metric is left out
    assert set(r["metrics"]) == {"setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["numbers"]["reads_checked"] >= 4 * 20
    assert r["device"]["platform"] == "cpu"
    assert set(r["checks"]) == set(TINY_LIMITS)


def test_traced_run_on_the_cpu(tmp_path):
    root = make_root(tmp_path)
    r = run(root, seconds=0.3, traced=True)
    assert r["correct"] is True, r["checks"]
    # no card: the device metrics find nothing to read and are left out
    assert set(r["metrics"]) == {"read_ms_per_batch", "write_ms_per_batch",
                                 "place_ms_per_batch", "batch_p95_ms", "gc_pause_pct",
                                 "reads_per_s.host"}
    assert r["metrics"]["reads_per_s.host"]["unit"] == "reads/s"
    assert r["metrics"]["reads_per_s.host"]["value"] > 0
    assert 0 < r["metrics"]["gc_pause_pct"]["value"] < 100
    assert "breakdown" not in r and "busy_s" not in r["device"]


def test_seed_gives_the_same_inputs(tmp_path):
    import numpy as np

    def inputs(seed, name):
        streams = harness.seeds(seed)
        db = harness._make_db(TINY_CONFIG, streams["db"])
        path = str(tmp_path / name)
        buf, off, iupac = harness._write_pool(path, db, TINY_TRAFFIC,
                                              np.random.default_rng(streams["reads"]))
        return db["scores"], db["newick"], Path(path).read_bytes()

    a, b, c = inputs(2**33 + 7, "a"), inputs(2**33 + 7, "b"), inputs(-5, "c")
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    assert a[2] != c[2] and a[1] != c[1]


def test_a_cell_added_by_files_alone(tmp_path):
    root = make_root(tmp_path)
    folder = root / "placebench"
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    (folder / "configs" / "extra.json").write_text(json.dumps(
        dict(TINY_CONFIG, name="extra",
             generator=dict(TINY_CONFIG["generator"], num_leaves=25, kmer_size=7))))
    (folder / "traffic" / "extra_mix.json").write_text(json.dumps(
        dict(TINY_TRAFFIC, lengths=[60, 80], iupac_share=0.0, batch=64)))
    (folder / "cells" / "extra.extra_mix.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    (folder / "metrics" / "extra_reads_per_batch.py").write_text(
        "def read(run):\n    return sum(n for _, _, n in run.batches) / len(run.batches)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra", "source": "test",
                             "file": "placebench/configs/extra.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "extra.extra_mix", "config": "extra",
                               "traffic": "extra_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "extra_reads_per_batch", "unit": "reads",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "card_ms_per_kread", "workloads": ["extra.extra_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell(root, "extra.extra_mix", 5, 0.3, True, device="cpu",
                         log=lambda line: None)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["extra_reads_per_batch"]["value"] == 64
    assert "read_ms_per_batch" not in r["metrics"]  # listed for the tiny cell only
    assert {p: p.read_bytes() for p in before} == before


class DropHalf:
    """Half of each batch left out."""

    def __init__(self, inner):
        self.inner = inner

    def place(self, batch):
        return self.inner.place(batch[: len(batch) // 2])


class Stale:
    """Every batch answered with the first batch's placements: the state
    never moves on."""

    def __init__(self, inner):
        self.inner, self.first = inner, None

    def place(self, batch):
        placed = self.inner.place(batch)
        if self.first is None:
            self.first = placed
        return self.first if placed is not self.first else placed


class Altered:
    """Each read's best row altered where the placer produces it: its edge
    moved to the next branch, or its likelihood moved by ``delta``."""

    def __init__(self, inner, edge: bool, delta: float = 0.0):
        self.inner, self.edge, self.delta = inner, edge, delta

    def place(self, batch):
        placed = self.inner.place(batch)
        if self.edge:
            placed.ids[:, 0] = (placed.ids[:, 0] + 1) % self.inner.B
        else:
            placed.scores[:, 0] += self.delta
        return placed


@pytest.mark.parametrize("fault,fails", [
    (DropHalf, {"lost_reads", "missing"}),
    (Stale, {"missing"}),
    (lambda p: Altered(p, edge=True), {"ll_gap"}),
    (lambda p: Altered(p, edge=False, delta=1e-3), {"ll_gap"}),
])
def test_faults_come_out_not_correct(tmp_path, fault, fails):
    root = make_root(tmp_path)
    r = run(root, seconds=0.5, wrap_placer=fault)
    assert r["correct"] is False
    failed = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert fails <= failed, r["checks"]


def test_control_comes_out_not_correct(tmp_path):
    """The control: the program's bfloat16 plane, one precision below the
    float32 the configuration states."""
    root = make_root(tmp_path)
    r = run(root, seconds=0.5, config_overrides={"precision": "bf16"})
    assert r["correct"] is False
    assert r["checks"]["ll_gap"]["value"] > TINY_LIMITS["ll_gap"], r["checks"]


def test_forbidden_module_stops_the_run(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.ForbiddenModules):
        run(root, seconds=0.2)


def test_run_py_needs_the_card_or_the_port(tmp_path):
    """Without a card (or, in a folder of the benchmark alone, without the
    port) run.py exits nonzero and prints no result."""
    root = make_root(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "placebench/run.py", "--workload", "tiny.short",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["d652.illumina150"])
def test_cell_on_the_card(cuda, workload):
    p = subprocess.run([sys.executable, "placebench/run.py", "--workload", workload,
                        "--seed", "2147483999", "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["d652.illumina150"])
def test_control_on_the_card(cuda, workload):
    """The bfloat16 control at the cell's own size on three seeds."""
    p = subprocess.run([sys.executable, "placebench/control.py", "--workload", workload,
                        "--seeds", "101,102,103", "--seconds", "3", "--precision", "bf16"],
                       cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)
