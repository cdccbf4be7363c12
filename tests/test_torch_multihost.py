"""Multi-process placement of the port on the CPU: two OS processes joined
over gloo (``parallel/mesh.py::init_distributed``), one global mesh, the
data groups' packs all-gathered at fetch time. Ports
``tests/test_multihost.py`` (:74, :78, :82, :164): the two-rank dense and CSR
parity runs of ``tools/multihost_worker.py`` (4 mesh slots a rank on the
CPU, n_model 2), the kill-restart-resume story and the watchdog; and adds the
mesh layout over processes, a budget retry on one rank's half, and the CLI's
multi-process flags against a single-process run. Model groups that span
processes: ``tests/test_torch_model_groups.py``.

Each spawned pair has its own time limit, and running past it fails the
test; only an address or bind error on the loopback coordinator skips.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from epik_tpu_torch.parallel import mesh as mesh_mod
from epik_tpu_torch.parallel.mesh import (
    STALL_EXIT_CODE,
    BatchWatchdog,
    CollectiveError,
    make_mesh,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = [sys.executable, "-m", "epik_tpu_torch.tools.multihost_worker"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pair(make_cmd, timeout: float):
    """Start ranks 0 and 1 (``make_cmd(rank, port)``), wait for both within
    ``timeout`` seconds; a pair still running then is killed and fails."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(make_cmd(rank, port), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=_REPO)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"rank pair on port {port} still running after {timeout} s")
    for out in outs:
        low = out.lower()
        if "address already in use" in low or "bind" in low and "error" in low:
            pytest.skip(f"loopback coordinator unavailable: {out[-400:]}")
    return procs, outs


def _run_pair(mode: str, timeout: float = 120.0):
    procs, outs = _spawn_pair(
        lambda rank, port: WORKER + [str(rank), "2", str(port), mode, "--platform", "cpu"],
        timeout)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "PARITY OK 24 (mesh 4x2, 1 all-gather(s))" in out, out[-2000:]


def test_two_process_dense_parity():
    _run_pair("dense")


def test_two_process_csr_parity():
    _run_pair("csr")


def test_kill_restart_resume(tmp_path):
    """Kill one rank mid-run: the survivor exits with STALL_EXIT_CODE rather
    than hanging (gloo reports the dead peer as a broken connection, or the
    watchdog sees the stall), with at least one whole batch flushed;
    restarting both ranks with --resume completes the stream from the jplace
    sidecar."""
    out_dir = str(tmp_path)
    jplace = os.path.join(out_dir, "placements_stream.jplace")

    def cmd(resume, kill_after):
        def make(rank, port):
            c = WORKER + [str(rank), "2", str(port), "stream", "--out", out_dir,
                          "--watchdog", "25", "--platform", "cpu"]
            if resume:
                c.append("--resume")
            if kill_after is not None and rank == 1:
                c += ["--kill-after", str(kill_after)]
            return c
        return make

    procs, outs = _spawn_pair(cmd(False, 2), timeout=150)
    assert procs[1].returncode == 1 and "FAULT INJECTION" in outs[1], outs[1][-1500:]
    assert procs[0].returncode == STALL_EXIT_CODE, outs[0][-1500:]
    assert "COLLECTIVE FAILURE" in outs[0] or "COLLECTIVE STALL" in outs[0]
    assert os.path.exists(jplace + ".resume"), "resume sidecar missing"
    with open(jplace + ".resume") as f:
        flushed = json.load(f)["reads"]
    assert flushed % 16 == 0 and 16 <= flushed < 80, flushed

    procs, outs = _spawn_pair(cmd(True, None), timeout=150)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert f"STREAM OK {80 - flushed}" in outs[0]
    assert not os.path.exists(jplace + ".resume"), "sidecar must clear"
    with open(jplace) as f:
        doc = json.load(f)
    names = {nm for pl in doc["placements"] for nm, _ in pl["nm"]}
    assert len(names) == 80 and "b4_q15" in names and "b0_q0" in names


def test_watchdog_unit():
    """BatchWatchdog fires only when armed past the deadline, and
    disarm/stop suppress it (in-process, injectable exit)."""
    import time

    fired = []
    dog = BatchWatchdog(0.3, rank=7, _exit=fired.append)
    time.sleep(0.5)
    assert fired == []
    dog.arm("fast step")
    dog.disarm()
    time.sleep(0.5)
    assert fired == []
    dog.arm("stuck step")
    time.sleep(0.8)
    assert fired == [STALL_EXIT_CODE]
    dog.stop()


def test_watchdog_guard_exits_on_a_broken_collective(capsys):
    """A CollectiveError inside ``guard`` exits with STALL_EXIT_CODE; any
    other error passes through, and the guard disarms either way."""
    fired = []
    dog = BatchWatchdog(30.0, rank=1, _exit=fired.append)
    with pytest.raises(CollectiveError):
        with dog.guard("batch 3"):
            raise CollectiveError("peer gone")
    assert fired == [STALL_EXIT_CODE] and dog._deadline is None
    assert "COLLECTIVE FAILURE: rank 1 step 'batch 3'" in capsys.readouterr().err
    with pytest.raises(ValueError):
        with dog.guard("batch 4"):
            raise ValueError("not a collective")
    assert fired == [STALL_EXIT_CODE] and dog._deadline is None
    dog.stop()


def _fake_world(monkeypatch, rank: int, per_rank: list[list[str]]):
    """This process as ``rank`` of ``len(per_rank)``, the other ranks
    contributing the device names ``per_rank`` lists."""
    import torch.distributed as dist

    monkeypatch.setattr(mesh_mod, "_world", lambda: (rank, len(per_rank)))

    def all_gather_object(out, obj):
        for r, names in enumerate(per_rank):
            out[r] = obj if r == rank else names

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)


@pytest.mark.parametrize("rank", [0, 1])
def test_global_mesh_lays_ranks_in_order(monkeypatch, rank):
    """Four CPU slots a rank, n_model 2: a 4x2 mesh, rows 0-1 on rank 0 and
    rows 2-3 on rank 1; each rank runs its own rows."""
    _fake_world(monkeypatch, rank, [["cpu"] * 4, ["cpu"] * 4])
    mesh = make_mesh(n_model=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.owners == ((0, 0), (0, 0), (1, 1), (1, 1))
    assert mesh.rank == rank and mesh.multi_process
    assert mesh.local_rows == ((0, 1) if rank == 0 else (2, 3))


def test_every_rank_owns_a_model_group(monkeypatch):
    """A 1x2 mesh over two ranks of two slots each would leave rank 1 idle,
    outside the all-gathers: it raises."""
    _fake_world(monkeypatch, 0, [["cpu"] * 2, ["cpu"] * 2])
    with pytest.raises(ValueError, match=r"ranks \[1\] own no model group"):
        make_mesh(n_data=1, n_model=2, devices=[torch.device("cpu")] * 2)


def test_single_process_mesh_owns_every_row():
    mesh = make_mesh(n_model=2, devices=[torch.device("cpu")] * 4)
    assert mesh.owners == () and mesh.local_rows == (0, 1) and not mesh.multi_process


_RETRY_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from epik_tpu_torch.core.alphabet import DNA
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import random_db
    from epik_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    rank, port = int(sys.argv[1]), sys.argv[2]
    init_distributed(f"127.0.0.1:{port}", 2, rank, 60)
    db = random_db(num_leaves=32, kmer_size=6, num_kmers=2048, seed=5)
    tree = parse_newick(db.tree())
    lens = np.diff(db.row_off)
    heavy = np.argsort(-lens, kind="stable")[:16]
    rng = np.random.default_rng(1)
    # the first half (rank 0's group) reads keys of one posting, the second
    # half (rank 1's) the keys with the longest lists: only rank 1's group
    # overflows the per-read posting budget
    light = np.flatnonzero(lens == lens.min())
    reads = []
    for i in range(128):
        pool = light if i < 64 else heavy
        s = "".join(DNA.decode_key(int(db.keys[j]), 6) for j in rng.choice(pool, 30))
        reads.append((f"q{i}", s.encode()))
    cfg = PlacerConfig(dense_db="off", tokenize_where="host", budget_headroom=0.5)
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_model=1, devices=[torch.device("cpu")]),
                                config=cfg)
    assert placer.route == "csr", placer.route
    out = placer.place(reads)
    # each half alone, in this process only: only the second half retries
    halves = [ShardedTorchPlacer(db, tree, Mesh(((torch.device("cpu"),),)), config=cfg)
              for _ in range(2)]
    halves[0].place(reads[:64])
    halves[1].place(reads[64:])
    assert [h.overflow_retries for h in halves] == [0, 1], [h.overflow_retries for h in halves]
    want = ReferencePlacer(db, tree).place(reads)
    got = {p.sequence: {x.branch_id: x.score for x in p.placements} for p in out.placed_seqs}
    assert len(got) == len(want.placed_seqs) == 128
    for p in want.placed_seqs:
        g = got[p.sequence]
        assert set(g) == {x.branch_id for x in p.placements}, p.sequence
        assert all(abs(g[x.branch_id] - x.score) < 1e-5 for x in p.placements), p.sequence
    print(f"RETRY OK rank {rank}: {placer.overflow_retries} retries, {placer.gathers} gathers",
          flush=True)
""")


def test_budget_retry_on_one_ranks_half(tmp_path):
    """A batch whose second half (rank 1's data group) overflows the CSR
    posting budget: both ranks see the gathered totals and re-run together,
    so the collectives stay matched, and both hold the oracle's placements."""
    script = tmp_path / "retry_rank.py"
    script.write_text(_RETRY_RANK)
    procs, outs = _spawn_pair(lambda rank, port: [sys.executable, str(script), str(rank),
                                                  str(port)], timeout=120)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("RETRY OK"))
        retries, gathers = int(line.split()[4]), int(line.split()[6])
        assert retries >= 1 and gathers == retries + 1, line


def test_cli_two_ranks_match_one_process(tmp_path):
    """``place --engine sharded`` as two ranks (``--coordinator``,
    ``--num-processes``, ``--process-id``) on the CPU: each rank writes the
    whole jplace, equal read by read to the single-process run's."""
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.io.db import save
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=20_000,
                                mean_posting_len=6.0, seed=41)
    save(db, tmp_path / "DB.eptk")
    reads = reads_from_reference(ref, 300, length=101, mutation_rate=0.05, seed=42)
    reads[5] = ("amb", reads[5][1][:30] + b"N" + reads[5][1][31:])
    reads[9] = ("short", b"ACG")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    base = [sys.executable, "-m", "epik_tpu_torch", "place", "-i", str(tmp_path / "DB.eptk"),
            "--engine", "sharded", "--platform", "cpu", "--batch-size", "64", "--verbose"]
    single = tmp_path / "single"
    single.mkdir()
    one = subprocess.run(base + ["-o", str(single), str(tmp_path / "q.fasta")], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-2000:]
    for r in (0, 1):
        (tmp_path / f"rank{r}").mkdir()
    procs, outs = _spawn_pair(lambda rank, port: base + [
        "-o", str(tmp_path / f"rank{rank}"), "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(rank), str(tmp_path / "q.fasta")],
        timeout=120)
    want = parse_jplace(str(single / "placements_q.fasta.jplace"))
    assert len(want) == 300
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert "sharded mesh 2x1 (dense)" in out and "All-gather: 5 over 5 batches" in out
        got = parse_jplace(str(tmp_path / f"rank{rank}" / "placements_q.fasta.jplace"))
        assert got == want
