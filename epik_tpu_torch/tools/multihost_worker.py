"""Multi-process placement worker: one rank of a 2+-process job.

Usage (one invocation per rank; also the multi-process usage example):

    python -m epik_tpu_torch.tools.multihost_worker RANK NPROC PORT [dense|csr] \
        [--platform cuda|cpu]

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
coordinator ``127.0.0.1:PORT``), contributes four mesh slots on its device
(``--platform``, default ``cuda``: the card, four times; ``cpu``: the CPU
four times) to a global ``(data, model)`` mesh of ``NPROC * 2`` data groups
by 2 model shards, places one deterministic batch with
:class:`~epik_tpu_torch.parallel.sharding.ShardedTorchPlacer` and checks
every read's best branch against the scalar oracle (the data groups' packs
are all-gathered at fetch time, so every rank checks the whole batch).
Prints ``PARITY OK <n>`` on success. ``dense`` places on the column-sharded
dense plane; ``csr`` on the hash-sharded CSR tables (kernel 4 with counts,
then the counts finish), the route the JAX worker's ``csr`` mode takes off
the TPU.
"""

from __future__ import annotations

import os
import sys

#: mesh slots each rank contributes, and the model shards of a data group
#: (the JAX worker's layout: 4 devices a process, n_model 2)
LOCAL_SLOTS = 4
N_MODEL = 2


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
    from ..engine.config import PlacerConfig
    from ..engine.reference import ReferencePlacer
    from ..io.build import random_db
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

    # the port's "auto" accumulate takes the posting tiles wherever they fit;
    # host tokenization keeps the batch on the hash-sharded CSR tables
    cfg = (PlacerConfig(dense_db="off", tokenize_where="host") if mode == "csr"
           else PlacerConfig())
    placer = ShardedTorchPlacer(db, tree, mesh, config=cfg)
    want = "csr" if mode == "csr" else "dense"
    assert placer.route == want, f"rank {rank}: route {placer.route}, expected {want}"
    out = placer.place(reads)

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
          f"{placer.gathers} all-gather(s))", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    rest = list(argv[3:])
    mode = rest.pop(0) if rest and not rest[0].startswith("--") else "dense"
    args = {"out": None, "resume": False, "kill_after": None, "watchdog": 30.0,
            "platform": "cuda"}
    it = iter(rest)
    for a in it:
        if a == "--out":
            args["out"] = next(it)
        elif a == "--resume":
            args["resume"] = True
        elif a == "--kill-after":
            args["kill_after"] = int(next(it))
        elif a == "--watchdog":
            args["watchdog"] = float(next(it))
        elif a == "--platform":
            args["platform"] = next(it)
        else:
            raise SystemExit(f"multihost_worker: unknown argument {a!r}")
    if mode not in ("dense", "csr", "stream") or args["platform"] not in ("cuda", "cpu"):
        raise SystemExit(f"multihost_worker: mode {mode!r}, platform {args['platform']!r}")

    import torch
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=rank,
                     initialization_timeout=120)
    mesh = make_mesh(n_model=N_MODEL, devices=[torch.device(args["platform"])] * LOCAL_SLOTS)
    rc = _stream(rank, mesh, args) if mode == "stream" else _parity(rank, mesh, mode)
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
