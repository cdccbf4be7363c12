"""Multi-process placement worker: one rank of a 2+-process job.

Usage (one invocation per rank; also the multi-process usage example):

    python -m epik_tpu_torch.tools.multihost_worker RANK NPROC PORT \
        [dense|csr|tiles|scatter[,...]] [--slots S] [--n-model M] \
        [--platform cuda|cpu] [--database DB.eptk --fasta Q.fasta \
        [--reads N] [--batch-size N]]

Streaming / failure-story mode:

    python -m epik_tpu_torch.tools.multihost_worker RANK NPROC PORT stream \
        --out DIR [--resume] [--kill-after K] [--watchdog S] [--platform cuda|cpu]

places a deterministic multi-batch stream through ``ShardedTorchPlacer``
with rank 0 writing a jplace file batch by batch (per-batch flush and an
atomic resume sidecar, ``io/jplace.py``). ``--kill-after K`` makes a non-zero
rank die abruptly before batch K (fault injection); the surviving ranks'
``BatchWatchdog`` (``parallel/mesh.py``) turns the stalled or broken
collective into exit code ``STALL_EXIT_CODE`` (42), so that a supervisor
restarts every rank with ``--resume``, which skips the batches already in
the sidecar (``tests/test_torch_multihost.py::test_kill_restart_resume``).

Each rank calls :func:`epik_tpu_torch.parallel.mesh.init_distributed` (gloo,
coordinator ``127.0.0.1:PORT``) and contributes ``--slots`` mesh slots on its
device (``--platform``, default ``cuda``: the card, repeated; ``cpu``: the
CPU, repeated) to a global ``(data, model)`` mesh of ``--n-model`` model
shards a data group. The default, 4 slots and n_model 2, lays ``NPROC * 2``
data groups, each within one rank; ``--slots 1 --n-model 2`` on two ranks is
the JAX worker's layout on one device a process (``epik_tpu/tools/
multihost_worker.py:150-152``): one data group whose two shards lie in two
processes, which exchange their partial results (``parallel/exchange.py``).
Each mode places one deterministic batch with
:class:`~epik_tpu_torch.parallel.sharding.ShardedTorchPlacer` and checks
every read's best branch against the scalar oracle (the data groups' packs
are all-gathered at fetch time, so every rank checks the whole batch).
Prints ``PARITY OK <n> (mesh DxM, <g> all-gather(s))``, the model exchanges
and the kernel launches, for each mode of a comma-separated list. ``dense``
places on the column-sharded dense plane; ``csr`` on the hash-sharded CSR
tables (kernel 4 with counts, then the counts finish), the route the JAX
worker's ``csr`` mode takes off the TPU; ``tiles`` on the column-sharded
posting tiles; ``scatter`` on the CSR tables with flat posting budgets
(``accumulate="scatter"``).

With ``--database`` and ``--fasta`` a mode places the file's first
``--reads`` reads in batches of ``--batch-size`` instead, then places them
again in this process alone on a single-process mesh of the same shape laid
on this rank's device, and requires every read equal; it prints ``FILE OK``
with the reads/s and, a batch, the all-gather's and the model exchange's
milliseconds and megabytes.
"""

from __future__ import annotations

import os
import sys
import time

#: mesh slots each rank contributes, and the model shards of a data group
#: (the JAX worker's layout: 4 devices a process, n_model 2)
LOCAL_SLOTS = 4
N_MODEL = 2
#: the route each mode must take
ROUTES = {"dense": "dense", "csr": "csr", "tiles": "tiles", "scatter": "csr"}


def _config(mode: str):
    """The placer configuration of a mode. The port's "auto" accumulate takes
    the posting tiles wherever they fit; host tokenization keeps ``csr`` on
    the hash-sharded CSR tables."""
    from ..engine.config import PlacerConfig

    return {"dense": PlacerConfig(), "csr": PlacerConfig(dense_db="off", tokenize_where="host"),
            "tiles": PlacerConfig(dense_db="off"),
            "scatter": PlacerConfig(accumulate="scatter")}[mode]


def _exchange_line(placer, batches: int) -> str:
    return (f"{placer.model_exchanges} model exchange(s), "
            f"{placer.model_exchange_seconds * 1e3 / max(1, batches):.3f} ms a batch")


def _stream(rank, mesh, args):
    """The failure-story streaming loop: jplace + sidecar + watchdog."""
    import json

    import numpy as np

    from ..core.alphabet import DNA
    from ..core.tree import parse_newick
    from ..engine.config import PlacerConfig
    from ..io.build import random_db
    from ..io.jplace import jplace_writer
    from ..parallel.mesh import BatchWatchdog
    from ..parallel.sharding import ShardedTorchPlacer

    out_dir = args["out"]
    n_batches, batch_size = 5, 16

    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=11)
    tree = parse_newick(db.tree())
    rng = np.random.default_rng(3)
    batches = []
    for b in range(n_batches):
        batch = []
        for i in range(batch_size):
            parts = [DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                     for _ in range(6)]
            batch.append((f"b{b}_q{i}", "".join(parts).encode()))
        batches.append(batch)

    placer = ShardedTorchPlacer(db, tree, mesh, config=PlacerConfig())
    path = os.path.join(out_dir, "placements_stream.jplace")
    writer = None
    skip = 0
    if rank == 0:
        writer = jplace_writer(path, "epik_tpu_torch multihost_worker stream ",
                               db.tree_newick, resume=args["resume"])
        writer.start()
        skip = writer.resumed_reads // batch_size
    # every rank must agree on how many batches to skip: the sidecar is on a
    # shared filesystem (the same contract as the shared output directory)
    sidecar = path + ".resume"
    if rank != 0 and args["resume"] and os.path.exists(sidecar):
        with open(sidecar) as f:
            skip = json.load(f)["reads"] // batch_size

    dog = BatchWatchdog(args["watchdog"], rank=rank)
    for b in range(skip, n_batches):
        if args["kill_after"] is not None and rank != 0 and b >= args["kill_after"]:
            print(f"FAULT INJECTION: rank {rank} dying before batch {b}", flush=True)
            os._exit(1)
        with dog.guard(f"batch {b}"):
            placed = placer.place(batches[b])
        if writer is not None:
            writer << placed
    dog.stop()
    if writer is not None:
        writer.end()
    print(f"STREAM OK {sum(len(b) for b in batches[skip:])}", flush=True)
    return 0


def _parity(rank, mesh, mode) -> int:
    """One deterministic batch on the global mesh against the oracle."""
    import numpy as np

    from ..core.alphabet import DNA
    from ..core.tree import parse_newick
    from ..engine.reference import ReferencePlacer
    from ..io.build import random_db
    from ..kernels import launch_counts, reset_launch_counts
    from ..parallel.sharding import ShardedTorchPlacer

    # deterministic fixture: every rank builds the identical DB and batch
    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=11)
    tree = parse_newick(db.tree())
    rng = np.random.default_rng(2)
    reads = []
    for i in range(24):
        parts = [DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                 for _ in range(6)]
        reads.append((f"q{i}", "".join(parts).encode()))

    placer = ShardedTorchPlacer(db, tree, mesh, config=_config(mode))
    assert placer.route == ROUTES[mode], (f"rank {rank}: route {placer.route}, expected "
                                          f"{ROUTES[mode]}")
    reset_launch_counts()
    out = placer.place(reads)
    launched = {name: n for name, n in launch_counts().items() if n}

    oracle = ReferencePlacer(db, tree).place(reads)
    best = {p.sequence: p.placements[0].branch_id for p in oracle.placed_seqs if p.placements}
    n = 0
    for p in out.placed_seqs:
        if p.placements and p.sequence in best:
            assert p.placements[0].branch_id == best[p.sequence], (
                f"rank {rank}: multi-process {mode} diverges from the oracle on "
                f"{p.sequence!r}")
            n += 1
    assert n >= len(reads) - 1, f"rank {rank}: only {n} reads verified"
    print(f"PARITY OK {n} (mesh {mesh.shape['data']}x{mesh.shape['model']}, "
          f"{placer.gathers} all-gather(s)) {mode}: {_exchange_line(placer, 1)}; "
          f"launches {launched}", flush=True)
    return 0


def _file(rank, mesh, mode, args) -> int:
    """A database file and a FASTA on the global mesh, then again on a
    single-process mesh of the same shape laid on this rank's device; every
    read must be equal."""
    import torch

    from ..core.tree import parse_newick
    from ..io.db import load
    from ..io.fasta import read_fasta
    from ..kernels import launch_counts, reset_launch_counts
    from ..parallel.mesh import Mesh
    from ..parallel.sharding import ShardedTorchPlacer

    db = load(args["database"], mu=1.0, user_omega=1.5)
    tree = parse_newick(db.tree())
    reads = read_fasta(args["fasta"])[:args["reads"]]
    size = args["batch_size"]
    batches = [reads[i:i + size] for i in range(0, len(reads), size)]
    cuda = args["platform"] == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    placer = ShardedTorchPlacer(db, tree, mesh, config=_config(mode))
    assert placer.route == ROUTES[mode], f"rank {rank}: route {placer.route}"
    placer.place(batches[0])  # warm-up: the kernels' first launches, the groups' connections
    sync()
    xg = placer._exchange
    g0, gs0, xe0 = placer.gathers, placer.gather_seconds, xg.exchanges
    reset_launch_counts()
    got, xms, xmb = [], [], []
    t0 = time.perf_counter()
    for b in batches:
        xs0, xb0 = xg.seconds, xg.nbytes
        got.append(placer.place(b).placed_seqs)
        xms.append(round((xg.seconds - xs0) * 1e3, 3))
        xmb.append(round((xg.nbytes - xb0) / 1e6, 3))
    sync()
    seconds = time.perf_counter() - t0
    launched = {name: n for name, n in launch_counts().items() if n}
    nb = len(batches)
    line = (f"FILE OK {len(reads)} {mode} (mesh {mesh.shape['data']}x{mesh.shape['model']}): "
            f"{len(reads) / seconds:.0f} reads/s; all-gather "
            f"{(placer.gather_seconds - gs0) * 1e3 / nb:.3f} ms a batch "
            f"({placer.gathers - g0} over {nb} batches); model exchange "
            f"{sum(xms) / nb:.3f} ms a batch ({xg.exchanges - xe0} exchanges, "
            f"{sum(xmb) / nb:.3f} MB a batch received); by batch: ms {xms}, MB {xmb}; "
            f"launches {launched}")
    del placer
    if cuda:
        torch.cuda.empty_cache()
    alone = ShardedTorchPlacer(db, tree, Mesh(_alone_devices(mesh)), config=_config(mode))
    want = [alone.place(b).placed_seqs for b in batches]
    for b, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"rank {rank}: batch {b} differs from the single-process run"
    print(line, flush=True)
    return 0


def _alone_devices(mesh):
    """The global mesh's shape as one process's devices: every cell on this
    rank's first device."""
    d0 = mesh.local_rows[0]
    dev = mesh.devices[d0][mesh.local_shards(d0)[0]]
    return tuple((dev,) * len(row) for row in mesh.devices)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    rest = list(argv[3:])
    modes = (rest.pop(0) if rest and not rest[0].startswith("--") else "dense").split(",")
    args = {"out": None, "resume": False, "kill_after": None, "watchdog": 30.0,
            "platform": "cuda", "slots": LOCAL_SLOTS, "n_model": N_MODEL, "database": None,
            "fasta": None, "reads": 1 << 30, "batch_size": 16384}
    it = iter(rest)
    for a in it:
        if a == "--resume":
            args["resume"] = True
        elif a in ("--out", "--platform", "--database", "--fasta"):
            args[a[2:]] = next(it)
        elif a in ("--kill-after", "--slots", "--n-model", "--reads", "--batch-size"):
            args[a[2:].replace("-", "_")] = int(next(it))
        elif a == "--watchdog":
            args["watchdog"] = float(next(it))
        else:
            raise SystemExit(f"multihost_worker: unknown argument {a!r}")
    known = set(ROUTES) | ({"stream"} if len(modes) == 1 else set())
    if (not set(modes) <= known or args["platform"] not in ("cuda", "cpu")
            or (args["database"] is None) != (args["fasta"] is None)):
        raise SystemExit(f"multihost_worker: modes {modes}, platform {args['platform']!r}, "
                         f"--database and --fasta go together")

    import torch
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=rank,
                     initialization_timeout=120)
    mesh = make_mesh(n_model=args["n_model"],
                     devices=[torch.device(args["platform"])] * args["slots"])
    if modes == ["stream"]:
        rc = _stream(rank, mesh, args)
    else:
        rc = max(_file(rank, mesh, mode, args) if args["database"] else
                 _parity(rank, mesh, mode) for mode in modes)
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
