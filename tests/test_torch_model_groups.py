"""Model groups that span processes, on the CPU over gloo.

A mesh row whose shards lie in several ranks: ``parallel/mesh.py::make_mesh``
records the owner of every cell, each rank runs the kernels of its own
shards, and ``parallel/exchange.py::ModelExchange`` gives every rank of the
row every shard's partial results before the merge, which then runs in shard
order as in one process.

* The layout, with a faked world: one slot a rank with n_model 2 (a 1x2 mesh
  over ranks 0 and 1), three ranks of two slots on a 2x3 mesh (rank 1 in both
  rows), a rank that holds no shard (raises).
* The exchange in one process: bytes of mixed dtypes and shapes round-trip in
  shard order; a failed collective raises ``CollectiveError``, also out of
  ``ShardedTorchPlacer.place``, which never merges its own shards alone.
* Spawned ranks, each group within its own time limit: layouts (a) 2 ranks x
  1 slot, 1x2; (b) 2 ranks x 2 slots, 1x4; (c) 3 ranks x 2 slots, 2x3. Each
  places the shifted dense route (pair plane), the classic dense route, the
  tiles (``dense_db="off"``) with an IUPAC batch that goes to the CSR step,
  ``accumulate="scatter"``, and a batch whose hot shard forces a budget
  retry, in one process group. Every fetched pack (retries included) is bit
  for bit the single-process port's on the same mesh shape
  (``make_mesh(n_data, n_model, devices=[cpu] * n)``), every rank takes the
  same retries, every read is within 1e-4 of the oracle, and the dense and
  tile routes are within ``tests/test_torch_sharding.py::_both_close``'s 1e-4
  of ``ShardedJaxPlacer`` on a virtual mesh of the same shape.
* ``tools/multihost_worker.py --slots 1 --n-model 2`` (every mode, and the
  file mode), ``place --engine sharded --n-model 2 --num-processes 2`` against
  the single-process 1x2 run, and a rank killed before an exchange: the
  survivor exits with ``STALL_EXIT_CODE``.

This file is also the ranks' script: ``python tests/test_torch_model_groups.py
RANK NPROC PORT SLOTS N_MODEL OUT_DIR``.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # as the ranks' script
    sys.path.insert(0, _REPO)

from epik_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from epik_tpu_torch.parallel.mesh import STALL_EXIT_CODE, CollectiveError, Mesh, make_mesh  # noqa: E402

CPU = torch.device("cpu")
#: name -> (ranks, slots a rank, n_data, n_model)
LAYOUTS = {"a_2x1_1x2": (2, 1, 1, 2), "b_2x2_1x4": (2, 2, 1, 4), "c_3x2_2x3": (3, 2, 2, 3)}
ROUTES = ("shifted", "classic", "tiles", "scatter", "retry")
#: the routes ShardedJaxPlacer takes too, and its configuration for each
JAX_ROUTES = {"shifted": {}, "classic": {"plane_mode": "classic"},
              "tiles": {"dense_db": "off", "accumulate": "matmul"}}
WORKER = [sys.executable, "-m", "epik_tpu_torch.tools.multihost_worker"]


# ---- the placements each layout makes (ranks and the single process alike) ----------------


def _fixture(n_model: int):
    """The database, its tree, a mixed batch (IUPAC, shorter than k, no hit),
    a clean batch, and a batch of reads made of the keys with the longest
    posting lists among those that hash to the last shard: the hot shard,
    which a rank other than the row's lead holds on every layout."""
    from epik_tpu_torch.core.alphabet import DNA
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel.sharding import _shard_of_key

    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=20_000,
                                mean_posting_len=6.0, seed=171)
    tree = parse_newick(db.tree())
    clean = reads_from_reference(ref, 36, length=101, mutation_rate=0.05, seed=172)
    mixed = clean[:30] + [("amb", clean[0][1][:40] + b"N" + clean[0][1][41:]),
                          ("short", b"AC"), ("nohit", b"T" * 30)]
    lens = np.diff(db.row_off)
    last = np.flatnonzero(_shard_of_key(db.keys, n_model) == n_model - 1)
    heavy = last[np.argsort(-lens[last], kind="stable")[:16]]
    rng = np.random.default_rng(173)
    hot = [(f"hot{i}", "".join(DNA.decode_key(int(db.keys[j]), 8)
                               for j in rng.choice(heavy, 30)).encode()) for i in range(24)]
    return db, tree, {"mixed": mixed, "clean": clean, "hot": hot}


def _route_setup(route: str, reads: dict):
    """(PlacerConfig keywords, the placer's route, batches) of a route."""
    return {
        "shifted": ({}, "dense", [reads["mixed"]]),
        "classic": ({"plane_mode": "classic"}, "dense", [reads["mixed"]]),
        "tiles": ({"dense_db": "off"}, "tiles", [reads["clean"], reads["mixed"]]),
        "scatter": ({"accumulate": "scatter"}, "csr", [reads["clean"], reads["mixed"]]),
        "retry": ({"dense_db": "off", "tokenize_where": "host", "budget_headroom": 0.5}, "csr",
                  [reads["hot"]]),
    }[route]


def _place_routes(mesh) -> dict:
    """Every route on ``mesh``: each fetched pack (the all-gathered host
    array, retries included), each batch's placements, and the counters."""
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, tree, reads = _fixture(mesh.shape["model"])
    out = {}
    for route in ROUTES:
        kw, want, batches = _route_setup(route, reads)
        placer = ShardedTorchPlacer(db, tree, mesh, config=PlacerConfig(**kw))
        assert placer.route == want, (route, placer.route)
        assert route != "shifted" or placer._paired, "the shifted route lost its pair plane"
        fetches = []
        fetch = placer._fetch

        def recorded(o, tag, fetch=fetch, fetches=fetches):
            fetches.append(fetch(o, tag))
            return fetches[-1]

        placer._fetch = recorded
        placed = [placer.place(b).placed_seqs for b in batches]
        out[route] = dict(fetches=fetches, placed=placed, retries=placer.overflow_retries,
                          exchanges=placer.model_exchanges, gathers=placer.gathers)
    return out


def _rank_main(argv) -> int:
    import torch.distributed as dist

    from epik_tpu_torch.parallel.mesh import init_distributed

    rank, nproc, port, slots, n_model, out_dir = (int(argv[0]), int(argv[1]), argv[2],
                                                  int(argv[3]), int(argv[4]), argv[5])
    init_distributed(f"127.0.0.1:{port}", nproc, rank, 60)
    mesh = make_mesh(n_model=n_model, devices=[CPU] * slots)
    res = _place_routes(mesh)
    res["layout"] = dict(owners=mesh.owners, local_rows=mesh.local_rows)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print(f"RANK OK {rank}", flush=True)
    return 0


# ---- spawning ----------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(nproc: int, make_cmd, timeout: float):
    """Start ranks 0..nproc-1 (``make_cmd(rank, port)``) and wait for all
    within ``timeout`` seconds; a group still running then is killed and
    fails. Only an address or bind error on the loopback coordinator skips."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(make_cmd(rank, port), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=_REPO)
             for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{nproc} ranks on port {port} still running after {timeout} s")
    for out in outs:
        low = out.lower()
        if "address already in use" in low or "bind" in low and "error" in low:
            pytest.skip(f"loopback coordinator unavailable: {out[-400:]}")
    return procs, outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(layout)``: (every rank's results, the single-process port's on
    the same mesh shape), each layout spawned once."""
    cache = {}

    def get(layout: str):
        if layout not in cache:
            nproc, slots, n_data, n_model = LAYOUTS[layout]
            d = tmp_path_factory.mktemp(layout)
            procs, outs = _spawn(nproc, lambda rank, port: [
                sys.executable, os.path.abspath(__file__), str(rank), str(nproc), str(port),
                str(slots), str(n_model), str(d)], timeout=150)
            for p, out in zip(procs, outs):
                assert p.returncode == 0, out[-3000:]
            ranks = []
            for rank in range(nproc):
                with open(d / f"rank{rank}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            single = _place_routes(make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model)))
            cache[layout] = ranks, single
        return cache[layout]

    return get


# ---- the layout ---------------------------------------------------------------------------


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
def test_one_slot_a_rank_lays_a_row_over_two_ranks(monkeypatch, rank):
    """One slot a rank with n_model 2 (JAX's worker on one device a process):
    a 1x2 mesh whose cells ranks 0 and 1 own; rank 0 leads the row."""
    _fake_world(monkeypatch, rank, [["cpu"], ["cpu"]])
    mesh = make_mesh(n_model=2, devices=[CPU])
    assert mesh.shape == {"data": 1, "model": 2} and mesh.multi_process
    assert mesh.owners == ((0, 1),) and mesh.rank == rank
    assert mesh.local_rows == (0,) and mesh.local_shards(0) == (rank,)
    assert mesh.row_ranks(0) == (0, 1) and mesh.lead(0) == 0
    assert [mesh.owner(0, m) for m in range(2)] == [0, 1]


@pytest.mark.parametrize("rank,rows,shards", [(0, (0,), {0: (0, 1)}),
                                              (1, (0, 1), {0: (2,), 1: (0,)}),
                                              (2, (1,), {1: (1, 2)})])
def test_three_ranks_of_two_slots_put_rank_1_in_both_rows(monkeypatch, rank, rows, shards):
    """A 2x3 mesh over three ranks of two slots: row 0 on ranks (0, 0, 1),
    row 1 on (1, 2, 2); rank 1 holds a shard of each row."""
    _fake_world(monkeypatch, rank, [["cpu"] * 2] * 3)
    mesh = make_mesh(n_data=2, n_model=3, devices=[CPU] * 2)
    assert mesh.owners == ((0, 0, 1), (1, 2, 2))
    assert mesh.local_rows == rows
    assert {d: mesh.local_shards(d) for d in rows} == shards
    assert (mesh.row_ranks(0), mesh.row_ranks(1)) == ((0, 1), (1, 2))
    assert (mesh.lead(0), mesh.lead(1)) == (0, 1)


@pytest.mark.parametrize("rank", [0, 2])
def test_a_rank_that_holds_no_shard_raises(monkeypatch, rank):
    """Three ranks of one slot under a 1x2 mesh: rank 2 holds no cell and
    would sit outside every collective, on every rank's view."""
    _fake_world(monkeypatch, rank, [["cpu"]] * 3)
    with pytest.raises(ValueError, match=r"ranks \[2\] own no model group"):
        make_mesh(n_data=1, n_model=2, devices=[CPU])


def test_single_process_mesh_keeps_no_owners():
    mesh = make_mesh(2, 2, devices=[CPU] * 4)
    assert mesh.owners == () and not mesh.multi_process and mesh.local_rows == (0, 1)
    assert mesh.local_shards(1) == (0, 1) and mesh.lead(1) == 0 and mesh.row_ranks(0) == (0,)


# ---- the exchange in one process ------------------------------------------------------------


def _fake_row(monkeypatch, owners=((0, 1),)):
    """A :class:`ModelExchange` of rank 0 on a mesh whose rows span ranks,
    its groups made by a fake ``new_group``."""
    import torch.distributed as dist

    from epik_tpu_torch.parallel.exchange import ModelExchange

    monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: ("group", tuple(ranks)))
    mesh = Mesh(tuple((CPU,) * len(row) for row in owners), owners, 0)
    return ModelExchange(mesh)


def test_exchange_round_trips_every_dtype_in_shard_order(monkeypatch):
    """Rank 0 holds shards 0 and 2 of a row of four, rank 1 shards 1 and 3:
    every shard's (f32, int32, int64 0-dim, bool) tuple comes back in shard
    order, bit for bit, the other rank's from the bytes it sent."""
    import torch.distributed as dist

    xg = _fake_row(monkeypatch, owners=((0, 1, 0, 1),))
    assert xg._groups == {0: ("group", (0, 1))} and xg.row(0) is not None

    def shard(m):
        g = torch.Generator().manual_seed(m)
        return (torch.randn(5, 3, generator=g), torch.randint(-9, 9, (5, 2), generator=g,
                                                              dtype=torch.int32),
                torch.tensor(1000 + m), torch.rand(4, generator=g) > 0.5)

    sent = []

    def all_gather(out, send, group=None):
        assert group == ("group", (0, 1))
        sent.append(send.clone())
        out[0].copy_(send)
        theirs = [torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in shard(m)])
                  for m in (1, 3)]
        out[1].copy_(torch.cat(theirs))

    monkeypatch.setattr(dist, "all_gather", all_gather)
    parts = [shard(0), None, shard(2), None]
    got = xg.gather(0, parts)
    assert len(got) == 4
    for m, tensors in enumerate(got):
        for t, w in zip(tensors, shard(m)):
            assert t.dtype == w.dtype and t.shape == w.shape and torch.equal(t, w)
    assert xg.exchanges == 1 and xg.nbytes == sent[0].numel() and xg.seconds >= 0.0
    with pytest.raises(ValueError, match="shards"):
        xg.gather(0, [shard(0), shard(1), None, None])


def test_a_failed_exchange_raises_collective_error(monkeypatch):
    import torch.distributed as dist

    xg = _fake_row(monkeypatch)

    def broken(out, send, group=None):
        raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(dist, "all_gather", broken)
    with pytest.raises(CollectiveError, match="model-axis exchange of data group 0"):
        xg.gather(0, [(torch.zeros(2),), None])


@pytest.mark.parametrize("cfg", [{}, {"dense_db": "off"}, {"accumulate": "scatter"}])
def test_placer_never_merges_its_own_shards_alone(monkeypatch, cfg):
    """Rank 0 of a 1x2 mesh over two ranks whose exchange breaks: ``place``
    raises CollectiveError on the dense, tile and CSR routes; nothing is
    placed from rank 0's shard alone."""
    import torch.distributed as dist

    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.parallel import sharding

    monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: ("group", tuple(ranks)))
    monkeypatch.setattr(sharding, "_agreed_budget", lambda budget: budget)

    def broken(out, send, group=None):
        raise RuntimeError("Connection reset by peer")

    monkeypatch.setattr(dist, "all_gather", broken)
    monkeypatch.setattr(sharding, "_gather_groups",
                        lambda local, tag: pytest.fail("gathered a pack past a failed exchange"))
    db, tree, reads = _fixture(2)
    placer = sharding.ShardedTorchPlacer(db, tree, Mesh(((CPU, CPU),), ((0, 1),), 0),
                                         config=PlacerConfig(**cfg))
    assert placer._exchange.row(0) is not None
    with pytest.raises(CollectiveError):
        placer.place(reads["clean"])


# ---- spawned layouts --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_equal_the_single_process_port(runs, layout, route):
    """Every rank's fetched packs, retries included, bit-equal to the single
    process on the same mesh shape; the same placements, retries and
    all-gathers on every rank; an exchange in every step of a rank's rows;
    every read within 1e-4 of the oracle."""
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from test_torch_placer import assert_jplace_close

    ranks, single = runs(layout)
    nproc, _, n_data, n_model = LAYOUTS[layout]
    want = single[route]
    for rank, res in enumerate(ranks):
        got = res[route]
        assert len(got["fetches"]) == len(want["fetches"]) == len(want["placed"]) + want["retries"]
        for g, w in zip(got["fetches"], want["fetches"]):
            assert g.shape == w.shape and np.array_equal(g, w, equal_nan=True), (rank, route)
        assert got["placed"] == want["placed"], (rank, route)
        assert got["retries"] == want["retries"] and got["gathers"] == len(want["fetches"])
        rows = res["layout"]["local_rows"]
        spanning = [d for d in rows if len(set(res["layout"]["owners"][d])) > 1]
        assert got["exchanges"] == len(spanning) * len(want["fetches"]) > 0, (rank, route)
    assert want["exchanges"] == 0
    if route == "retry":
        assert want["retries"] >= 1, "the hot shard did not overflow its budget"
    db, tree, reads = _fixture(n_model)
    batches = _route_setup(route, reads)[2]
    oracle = ReferencePlacer(db, tree)
    for batch, placed in zip(batches, ranks[-1][route]["placed"]):
        assert_jplace_close(oracle.place(batch), types.SimpleNamespace(placed_seqs=placed))


@pytest.mark.parametrize("route", list(JAX_ROUTES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_match_the_jax_sharded_placer(runs, layout, route):
    """The dense and tile routes on every layout within 1e-4 (score sets) of
    ``ShardedJaxPlacer`` on a virtual mesh of the same shape."""
    from epik_tpu.engine.placer import PlacerConfig as JaxConfig
    from epik_tpu.parallel import sharding as jax_sharding
    from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from test_torch_placer import assert_jplace_close

    ranks, _ = runs(layout)
    _, _, n_data, n_model = LAYOUTS[layout]
    db, tree, reads = _fixture(n_model)
    jp = jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(n_data, n_model),
                                       config=JaxConfig(**JAX_ROUTES[route]))
    for batch, placed in zip(_route_setup(route, reads)[2], ranks[0][route]["placed"]):
        assert_jplace_close(jp.place(batch), types.SimpleNamespace(placed_seqs=placed))


# ---- the entry points --------------------------------------------------------------------------


def test_worker_one_slot_a_rank_every_mode():
    """The JAX worker's layout (``--slots 1 --n-model 2``): one data group
    over both ranks, PARITY OK in every mode, one exchange each."""
    procs, outs = _spawn(2, lambda rank, port: WORKER + [
        str(rank), "2", str(port), "dense,csr,tiles,scatter", "--slots", "1", "--n-model", "2",
        "--platform", "cpu"], timeout=120)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        for mode in ("dense", "csr", "tiles", "scatter"):
            assert (f"PARITY OK 24 (mesh 1x2, 1 all-gather(s)) {mode}: 1 model exchange(s)"
                    in out), out[-2000:]


def _write_inputs(tmp_path, n_reads: int):
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.io.db import save

    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=20_000,
                                mean_posting_len=6.0, seed=41)
    save(db, tmp_path / "DB.eptk")
    reads = reads_from_reference(ref, n_reads, length=101, mutation_rate=0.05, seed=42)
    reads[5] = ("amb", reads[5][1][:30] + b"N" + reads[5][1][31:])
    reads[9] = ("short", b"ACG")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")


def test_worker_file_mode_equals_one_process(tmp_path):
    """``--database/--fasta`` in csr mode on the 1x2 layout: every read equal
    to the single-process 1x2 run in the rank, with the exchange's ms and MB."""
    _write_inputs(tmp_path, 100)
    procs, outs = _spawn(2, lambda rank, port: WORKER + [
        str(rank), "2", str(port), "csr", "--slots", "1", "--n-model", "2", "--platform",
        "cpu", "--database", str(tmp_path / "DB.eptk"), "--fasta", str(tmp_path / "q.fasta"),
        "--batch-size", "40"], timeout=120)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("FILE OK"))
        assert line.startswith("FILE OK 100 csr (mesh 1x2)") and "(3 exchanges" in line, line


def test_cli_two_ranks_span_one_model_group(tmp_path):
    """``place --engine sharded --n-model 2 --num-processes 2 --platform
    cpu``: one CPU slot a rank, one 1x2 data group over both ranks; each rank
    writes the whole jplace, equal read by read to the single-process 1x2
    run, and prints its model exchanges."""
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    _write_inputs(tmp_path, 200)
    base = [sys.executable, "-m", "epik_tpu_torch", "place", "-i", str(tmp_path / "DB.eptk"),
            "--engine", "sharded", "--n-model", "2", "--platform", "cpu", "--batch-size", "64",
            "--verbose"]
    (tmp_path / "single").mkdir()
    one = subprocess.run(base + ["-o", str(tmp_path / "single"), str(tmp_path / "q.fasta")],
                         cwd=_REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=_REPO))
    assert one.returncode == 0 and "sharded mesh 1x2 (dense)" in one.stdout, one.stderr[-2000:]
    for r in (0, 1):
        (tmp_path / f"rank{r}").mkdir()
    procs, outs = _spawn(2, lambda rank, port: base + [
        "-o", str(tmp_path / f"rank{rank}"), "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(rank), str(tmp_path / "q.fasta")],
        timeout=120)
    want = parse_jplace(str(tmp_path / "single" / "placements_q.fasta.jplace"))
    assert len(want) == 200
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert "sharded mesh 1x2 (dense)" in out and "All-gather: 4 over 4 batches" in out
        assert "Model exchange: 4 over 4 batches" in out, out[-2000:]
        got = parse_jplace(str(tmp_path / f"rank{rank}" / "placements_q.fasta.jplace"))
        assert got == want


def test_a_rank_killed_before_an_exchange_stops_its_row(tmp_path):
    """The stream on one slot a rank: rank 1 dies before batch 2, so rank 0's
    exchange of batch 2 breaks or stalls; rank 0 exits with STALL_EXIT_CODE
    (the watchdog's guard), after flushing the batches before it."""
    procs, outs = _spawn(2, lambda rank, port: WORKER + [
        str(rank), "2", str(port), "stream", "--slots", "1", "--n-model", "2", "--out",
        str(tmp_path), "--watchdog", "20", "--platform", "cpu"] + (
        ["--kill-after", "2"] if rank == 1 else []), timeout=150)
    assert procs[1].returncode == 1 and "FAULT INJECTION" in outs[1], outs[1][-1500:]
    assert procs[0].returncode == STALL_EXIT_CODE, outs[0][-1500:]
    assert "COLLECTIVE FAILURE" in outs[0] or "COLLECTIVE STALL" in outs[0]
    assert "STREAM OK" not in outs[0]


if __name__ == "__main__":
    raise SystemExit(_rank_main(sys.argv[1:]))
