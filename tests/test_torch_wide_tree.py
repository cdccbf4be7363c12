"""The unpaired dense plane past the width rule, through the benchmark's
harness on the CPU, and the sizes of the Web-of-Life-scale configuration.

A tree of 896 leaves (1,791 branches) gives a plane of 1,792 columns, the
first width past ``SHIFTED_TOPK_MAX_BW`` (1,664): the dense step runs the
gather and ``finish_topk`` apart, over the direct-table tokenizer
(``tokenize_packed``); ~12 postings a key post 0.7% of the plane's cells, so
the gather reads the plane's posted cells (``rowgather_sum_posted``), not
its rows (1d, ``rowgather_sum``). At the configuration's full size the pair
plane is over the card's budget, so the router takes the unpaired plane;
here the CPU's budget holds the pair plane, and ``pair_plane="off"`` stands
in for that budget. The jplace is held to ``placebench/reference.py``, the
NumPy scalar reference every cell is held to, with one IUPAC read in every
batch so the delta rows run too. The harness refuses to run beside JAX, so
the run is a process of its own.
"""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from placebench import gen, harness
from placebench.reference import Tree

REPO = Path(__file__).resolve().parents[1]

WIDE_CONFIG = {
    "name": "wide", "source": "test",
    "deployment": "a tree just past the width rule, for the CPU tests",
    "generator": {"num_leaves": 896, "kmer_size": 8, "ref_length": 20000,
                  "mean_posting_len": 12.0, "omega": 1.5},
    "placer": {"keep_at_most": 7, "keep_factor": 0.01,
               "config": {"host_threads": 1, "precision": "exact", "plane_mode": "shifted",
                          "pair_plane": "auto", "tile_payload": "auto"}},
    "route": "dense", "assumed": [], "reduced": []}
#: one batch of 100 reads, one of them with an N, placed again and again: every
#: batch written holds the IUPAC read, and the check takes every IUPAC read of
#: the batches it samples
WIDE_TRAFFIC = {"lengths": [150, 150], "divergence": 0.001, "iupac_share": 0.01,
                "iupac_per_read": [1, 1], "batch": 100, "inflight": 3, "pool_batches": 1,
                "warmup_batches": 1, "check": {"batches": 4, "reads": 20}}
#: the tiny cell's limits of placebench/tests/test_placebench_harness.py
WIDE_LIMITS = {"lost_reads": 0, "missing": 0, "length_gap": 0.0, "ll_gap": 2e-4,
               "lwr_gap": 1.5e-4}

RUN = r"""
import json, sys
from pathlib import Path

root, seed = Path(sys.argv[1]), int(sys.argv[2])
sys.path.insert(0, sys.argv[3])
from placebench import harness
import epik_tpu_torch.engine.step as step
from epik_tpu_torch.kernels.rowgather import shifted_fused

calls = {}

def counted(name):
    fn = getattr(step, name)

    def call(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)

    setattr(step, name, call)

for name in ("tokenize_packed", "rowgather_sum", "rowgather_sum_posted",
             "rowgather_sum_posted_topk", "finish_topk", "rowgather_sum_topk", "amb_deltas"):
    counted(name)
placer = {}

def wrap(p):
    bw = p.state.plane.shape[1]
    posted = p.state.posted
    placer.update(route=p.route, paired=p._paired, direct=p.state.direct is not None,
                  B=p.B, bw=bw, fused=shifted_fused(bw),
                  posted_share=None if posted is None else posted.nnz / p.state.plane.numel())
    return p

r = harness.run_cell(root, "wide.short", seed, 0.5, False, device="cpu",
                     config_overrides={"pair_plane": "off"}, wrap_placer=wrap,
                     log=lambda line: None)
print(json.dumps({"correct": r["correct"], "checks": r["checks"], "numbers": r["numbers"],
                  "failed": r["failed"], "placer": placer, "calls": calls}))
"""


def _wide_root(tmp: Path) -> Path:
    """A checkout with the benchmark's folder and a BENCHMARK.json of one
    wide cell."""
    shutil.copytree(REPO / "placebench", tmp / "placebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    folder = tmp / "placebench"
    (folder / "configs" / "wide.json").write_text(json.dumps(WIDE_CONFIG))
    (folder / "traffic" / "short.json").write_text(json.dumps(WIDE_TRAFFIC))
    (folder / "cells" / "wide.short.json").write_text(json.dumps({"limits": WIDE_LIMITS}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "wide", "source": "test", "file": "placebench/configs/wide.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "wide.short", "config": "wide", "traffic": "short",
                           "chips": 1, "why": "test"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_wide_tree_takes_the_unfused_pair_and_matches_the_reference(tmp_path):
    root = _wide_root(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", RUN, str(root), str(2**33 + 896), str(REPO)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    p = line["placer"]
    share = p.pop("posted_share")
    assert p == {"route": "dense", "paired": False, "direct": True, "B": 1791, "bw": 1792,
                 "fused": False}
    assert 0 < share < 1 / 32
    calls = line["calls"]
    # every batch: the direct-table tokenizer, the delta rows of its IUPAC
    # read and the posted gather with the finish fused in; never #1, 1d, the
    # posted gather alone nor finish_topk
    assert calls["tokenize_packed"] == calls["rowgather_sum_posted_topk"] > 0
    assert calls["amb_deltas"] == calls["rowgather_sum_posted_topk"]
    for name in ("rowgather_sum_topk", "rowgather_sum", "rowgather_sum_posted", "finish_topk"):
        assert name not in calls
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["numbers"]["reads_checked"] >= 4 * 20


def _wol10k():
    spec = harness.load_spec(REPO, "wol10k.illumina150")
    g = spec.config["generator"]
    db = gen.reference_like_db(g["num_leaves"], g["kmer_size"], g["ref_length"],
                               g["mean_posting_len"], g["omega"], seed=2**32 + 10575)
    return spec, db


def test_wol10k_loads_with_its_tree():
    spec, db = _wol10k()
    assert spec.config["name"] == "wol10k" and spec.config["route"] == "dense"
    assert spec.config["reduced"] == [] and spec.workload["chips"] == 1
    assert spec.traffic["batch"] == 2000 and spec.config["placer"]["config"]["pair_plane"] == "auto"
    assert db["newick"].count("L") == 10575
    assert Tree(db["newick"]).n == 21149


def test_wol10k_plane_fits_an_h100_and_its_pair_plane_does_not(monkeypatch):
    """The budget ``device_budget`` gives a card of 85.5e9 bytes, all free
    (the most it can give there): the unpaired f32 plane, 21,248 columns
    wide at the generator's key count, fits it; the pair plane does not, so
    the router takes the unpaired plane with no flag."""
    from epik_tpu_torch.engine.config import device_budget
    from epik_tpu_torch.engine.state import pair_tables

    _, db = _wol10k()
    card = int(85.5e9)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (card, card))
    budget = device_budget(torch.device("cuda"))
    n_keys = int(db["keys"].size)
    plane_w = -(-db["num_branches"] // 128) * 128
    assert plane_w == 21248 and 600_000 < n_keys < 700_000
    base_bytes = (n_keys + 1) * plane_w * 4
    assert 0.6 * card < base_bytes < budget
    pu, _, combo = pair_tables(types.SimpleNamespace(keys=db["keys"], num_kmers=n_keys), 10)
    paired_bytes = (n_keys + 1 + pu.shape[0]) * plane_w * 4 + combo.nbytes
    assert paired_bytes > budget


def _traced(ops, batches=2):
    summary = {"busy_s": 0.01, "window_s": 0.02, "ops": ops, "gaps": [],
               "n_device_events": len(ops)}
    return harness.Run(window=(0.0, 1.0), spans={}, stats=None, batches=[], trace=summary,
                       traced_batches=[(0, 0, 1)] * batches, device_name="NVIDIA H100 80GB HBM3",
                       pool=None, db=None, K=7, notes=[])


def test_finish_time_a_batch_reads_the_finish_kernels_alone():
    """``finish_ms_per_batch``: the device time of the kernels named
    ``finish_topk*`` over the traced batches; nothing to read where the step
    ran no finish apart (the fused #1) or there is no trace."""
    folder = REPO / "placebench"
    ops = {"rowgather_slices_kernel<float, 4, false>": 0.014,
           "finish_topk_kernel<false, 0>": 0.0025, "finish_topk_counts_kernel<true>": 0.0005,
           "rowgather_group_kernel<float, 4, false, false>": 0.001}
    assert harness.read_metric(folder, "finish_ms_per_batch", _traced(ops)) == pytest.approx(1.5)
    fused = {"rowgather_group_kernel<float, 4, false, false>": 0.001, "tokenize_combo_kernel": 1e-5}
    assert harness.read_metric(folder, "finish_ms_per_batch", _traced(fused)) is None
    run = _traced(ops)
    run.trace = None
    assert harness.read_metric(folder, "finish_ms_per_batch", run) is None
