"""Command-line interface of the port: ``python -m epik_tpu_torch <command>``.

The commands of ``epik_tpu/cli/main.py`` on ``argparse`` (the port does not
depend on click), with the JAX commands' arguments, output lines and exit
codes: ``place`` (:42-386), ``diff`` (:389-403), ``probe`` (:406-417),
``convert`` (:420-449), ``stats`` (:452-471), ``build-db`` (:474-504) and
``ppdiff`` (:507-519).

``place`` takes ``--platform cuda|cpu`` in place of the JAX platform flag. It loads the
database, builds the engine ``--engine`` names (:240-289): ``torch``, the
single-device :class:`~epik_tpu_torch.engine.placer.TorchPlacer`;
``sharded``, the multi-device
:class:`~epik_tpu_torch.parallel.sharding.ShardedTorchPlacer` over every card
(``--n-model`` model shards, the other cards data-parallel; with ``--platform
cpu`` over ``n_model`` repeats of the CPU device, or, multi-process, one CPU
slot a rank, as a one-card rank contributes its card); ``native``, the C++ scalar
placer; ``reference``, the scalar oracle. It streams the FASTA through
``engine.pipeline.run_pipeline`` into the jplace writer, and prints the same
lines as the JAX CLI to the same ``placements_<input>.jplace``.
``--profile-dir DIR`` records the run with ``torch.profiler`` (the host and,
on the card, its kernels) into a Chrome trace in ``DIR``, with the port's own
ranges (``utils/spans.py``: ``place.stage``, ``place.sync``, ``pipeline.write``,
...) beside them; ``--verbose`` prints the same spans as a table. The multi-process
flags (``--coordinator``, ``--num-processes``, ``--process-id``,
``--collective-timeout``) start one rank of a ``--engine sharded`` job over
gloo (``parallel/mesh.py::init_distributed``): each rank places every batch's
data groups on its own devices, gathers the others', and writes the whole
jplace to its own ``-o``; where ``--n-model`` lays a data group over several
ranks (``--n-model 2 --num-processes 2`` on one card a rank), its ranks
exchange the shards' partial results before the merge
(``parallel/exchange.py``). A batch that stalls past the timeout, or whose
collective (the all-gather or an exchange) breaks, exits with code 42 for a
restart with ``--resume``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..io.db import PKDB_VALUE_SIZE, load
from ..io.fasta import batch_fasta
from ..io.jplace import jplace_writer
from ..utils import spans
from ..utils.progress import (
    ProgressBar,
    humanize_time,
    parse_human_readable,
    to_human_readable,
)

from .. import __version__

__all__ = ["build_db", "convert", "diff", "main", "make_invocation", "make_output_filename",
           "place_queries", "ppdiff", "probe", "stats"]


def make_invocation(argv: list[str]) -> str:
    """argv joined with a trailing space (reference: main.cpp:23-32)."""
    return "".join(a + " " for a in argv)


def make_output_filename(input_file: str, output_dir: str) -> str:
    """placements_<input filename>.jplace (reference: main.cpp:34-37)."""
    return os.path.join(output_dir, "placements_" + os.path.basename(input_file) + ".jplace")


class _SkippingReader:
    """Reader adapter that skips the first n already-placed records (resume)."""

    def __init__(self, reader, skip: int):
        self._reader = reader
        self._skip = skip

    def next_batch(self):
        while True:
            batch = self._reader.next_batch()
            if not batch or self._skip == 0:
                return batch
            if len(batch) <= self._skip:
                self._skip -= len(batch)
                continue
            out = batch[self._skip :]
            self._skip = 0
            return out

    def bytes_read(self):
        return self._reader.bytes_read()


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)


def _open_reader(input_file: str, batch_size: int):
    """The native C++ FASTA reader when the host library loads (it does not
    read gzip), else the Python reader."""
    with open(input_file, "rb") as probe:
        is_gzip = probe.read(2) == b"\x1f\x8b"
    if not is_gzip:
        from .. import native

        try:
            if native.load_native() is not None:
                return native.NativeFastaReader(input_file, batch_size)
        except OSError:  # a library that this host cannot load
            pass
    return batch_fasta(input_file, batch_size)


def place_queries(database, states, omega, mu, outputdir, threads, max_ram,
                  input_file, batch_size=2000, keep_at_most=7, keep_factor=0.01,
                  invocation=None, resume=False, verbose=False, inflight=3,
                  precision="exact", plane_mode="shifted", pair_plane="auto",
                  tile_payload="auto", platform="cuda", engine="torch", n_model=1,
                  profile_dir=None, coordinator=None, num_processes=None,
                  process_id=None, collective_timeout=300.0) -> int:
    """Full pipeline orchestration (reference: main.cpp:237-383)."""
    if not (0.0 <= mu <= 1.0):
        _err("Error: Mu has to a value in [0, 1]")
        return -1

    max_entries = None
    if max_ram:
        try:
            max_bytes = parse_human_readable(max_ram)
        except ValueError as e:
            _err(f"Error: {e}")
            return -1
        max_entries = max_bytes // PKDB_VALUE_SIZE
        if max_entries == 0:
            _err("Error: Memory limit is too low")
            return -1
        print(f"Max-RAM provided: will be loaded not more than "
              f"{to_human_readable(max_entries)} phylo-k-mers.")

    print(f"Loading database with mu={mu:g} and omega={omega:g}...")
    try:
        db = load(database, mu=mu, user_omega=omega, max_entries=max_entries)
    except ValueError as e:
        _err(f"Error: {e}")
        return -1

    if db.sequence_type != states:
        _err(f"Error: database is {db.sequence_type} but -s {states} was requested")
        return -1

    print("Database parameters:")
    print(f"\tSequence type: {db.sequence_type}")
    print(f"\tk: {db.kmer_size}")
    print(f"\tomega: {db.omega:g}")
    print(f"\tPositions loaded: {'true' if db.positions_loaded else 'false'}")
    print("")
    print(f"Loaded {to_human_readable(db.get_num_entries_loaded())} of "
          f"{to_human_readable(db.get_num_entries_total())} phylo-k-mers. ")
    print("")

    from ..core.tree import parse_newick, to_newick
    from ..engine.pipeline import run_pipeline

    tree = parse_newick(db.tree())
    multi = engine == "sharded" and bool(coordinator or num_processes)
    if multi:
        from ..parallel.mesh import init_distributed

        # one invocation per process, a shared coordinator, one global mesh
        init_distributed(coordinator, num_processes=num_processes, process_id=process_id,
                         initialization_timeout=collective_timeout)
        # the all-gathers must meet in the same batch order on every rank
        inflight = 1
    placer, engine_name = _make_engine(engine, db, tree, keep_at_most=keep_at_most,
                                       keep_factor=keep_factor, threads=threads,
                                       precision=precision, plane_mode=plane_mode,
                                       pair_plane=pair_plane, tile_payload=tile_payload,
                                       platform=platform, n_model=n_model,
                                       multi=multi and (num_processes or 1) > 1)

    tree_as_newick = to_newick(tree, jplace_edges=True)
    jplace_filename = make_output_filename(input_file, outputdir)
    if invocation is None:
        invocation = make_invocation(sys.argv)
    total_fasta_size = os.path.getsize(input_file)

    writer = jplace_writer(jplace_filename, invocation, tree_as_newick, resume=resume)
    writer.start()
    if writer.resumed_reads:
        print(f"Resuming: {writer.resumed_reads} reads already placed.")

    print(f"Engine: {engine_name}")
    print(f"Placing {input_file}...")

    bar = ProgressBar(total_fasta_size)
    begin = time.monotonic()
    reader = _open_reader(input_file, batch_size)
    if writer.resumed_reads:
        reader = _SkippingReader(reader, writer.resumed_reads)

    def progress(seq_per_second, num_seq_placed, bytes_read):
        bar.update(
            bytes_read,
            prefix=f"{to_human_readable(seq_per_second)} seq/s ",
            postfix=f"{num_seq_placed} / ?",
        )

    # a dead peer leaves this rank blocked in a collective, or breaks it; the
    # watchdog turns either into a STALL_EXIT_CODE exit, so that a supervisor
    # restarts every rank with --resume
    dog = None
    inner = placer
    if num_processes and num_processes > 1:
        from ..parallel.mesh import BatchWatchdog

        dog = BatchWatchdog(collective_timeout, rank=process_id)

        class _Guarded:
            def place(self, batch):
                with dog.guard(f"batch of {len(batch)}"):
                    return inner.place(batch)

        placer = _Guarded()
    prof = _start_profiler(profile_dir, platform) if profile_dir else None
    # the port's spans, tallied as they close (bounded memory however long the run)
    tally = spans.Tally() if verbose or prof is not None else None
    if tally is not None:
        spans.enable(tally.add)
    try:
        stats = run_pipeline(placer, reader, writer, progress=progress, inflight=inflight)
    finally:
        if tally is not None:
            spans.disable()
        if dog is not None:
            dog.stop()
        if prof is not None:
            _stop_profiler(prof, profile_dir)
    writer.end()
    if verbose:
        from ..kernels import launch_counts

        print(f"Pipeline: {stats.summary()}")
        for line in tally.table():
            print(f"  {line}")
        launched = {name: n for name, n in launch_counts().items() if n}
        if launched:
            print(f"Kernel launches: {launched}")
        if getattr(inner, "gathers", 0):
            print(f"All-gather: {inner.gathers} over {stats.num_iterations} batches, "
                  f"{inner.gather_seconds * 1e3 / max(1, stats.num_iterations):.3f} ms per batch")
        if getattr(inner, "model_exchanges", 0):
            print(f"Model exchange: {inner.model_exchanges} over {stats.num_iterations} "
                  f"batches, {inner.model_exchange_seconds * 1e3 / max(1, stats.num_iterations):.3f}"
                  f" ms per batch")

    bar.update(reader.bytes_read(), prefix="Done. ",
               postfix=to_human_readable(stats.num_seq_placed))
    bar.finish()

    print(f"Placed {stats.num_seq_placed} sequences.\n"
          f"Average speed: {to_human_readable(stats.average_speed)} seq/s.")
    print(f"Output: {jplace_filename}")
    placement_time = int((time.monotonic() - begin) * 1000)
    print(f"Placement time: {humanize_time(placement_time)} ({placement_time} ms)")
    print("Done.")
    if multi:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _start_profiler(profile_dir: str, platform: str):
    """``torch.profiler`` over the host and, on the card, its kernels (JAX's
    ``jax.profiler.start_trace``, :356-369). A profiler that cannot start,
    or cannot trace the card, raises."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if platform == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("--profile-dir: this torch cannot trace CUDA kernels")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    # the pipeline places its batches on worker threads: trace every thread
    prof = profile(activities=activities, acc_events=True,
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prof.start()
    failed = [str(w.message) for w in caught
              if "cupti" in str(w.message).lower() or "fail" in str(w.message).lower()]
    if failed or not torch.autograd.profiler._is_profiler_enabled:
        raise RuntimeError(f"--profile-dir: the profiler did not start: {failed}")
    for w in caught:
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    if platform == "cuda":
        torch.cuda.synchronize()
    return prof


def _stop_profiler(prof, profile_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``profile_dir``."""
    import socket

    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(profile_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _make_engine(engine: str, db, tree, *, keep_at_most, keep_factor, threads, precision,
                 plane_mode, pair_plane, tile_payload, platform, n_model, multi=False):
    """(placer, engine line) for ``--engine`` (JAX ``place_queries``
    :240-289)."""
    if engine == "reference":
        from ..engine.reference import ReferencePlacer

        return (ReferencePlacer(db, tree, keep_at_most=keep_at_most, keep_factor=keep_factor),
                "scalar (oracle)")
    if engine == "native":
        from ..native import NativePlacer

        return (NativePlacer(db, tree, keep_at_most=keep_at_most, keep_factor=keep_factor,
                             threads=max(1, threads)),
                f"native C++ scalar (-j {max(1, threads)})")
    import torch

    from ..engine.config import PlacerConfig

    cfg = PlacerConfig(host_threads=max(1, threads), precision=precision,
                       plane_mode=plane_mode, pair_plane=pair_plane, tile_payload=tile_payload)
    if engine == "sharded":
        from ..parallel.mesh import make_mesh
        from ..parallel.sharding import ShardedTorchPlacer

        # the CPU mesh repeats the one CPU device, as JAX's virtual host
        # devices do; a rank of several contributes one CPU slot, as a rank
        # on one card does; "cuda" spans every card (and raises without CUDA)
        devices = ([torch.device("cpu")] * (1 if multi else n_model) if platform == "cpu"
                   else None)
        mesh = make_mesh(n_model=n_model, devices=devices)
        placer = ShardedTorchPlacer(db, tree, mesh, keep_at_most=keep_at_most,
                                    keep_factor=keep_factor, config=cfg)
        shape = mesh.shape
        return placer, (f"torch/{platform} sharded mesh {shape['data']}x{shape['model']} "
                        f"({placer.route})")
    from ..engine.placer import TorchPlacer

    placer = TorchPlacer(db, tree, keep_at_most=keep_at_most, keep_factor=keep_factor,
                         config=cfg, device=platform)
    n_dev = torch.cuda.device_count() if placer.device.type == "cuda" else 1
    return placer, (f"torch/{placer.device.type} ({n_dev} device(s), {placer.route})"
                    f"{placer.posted_line()}")


def _existing_file(path: str) -> str:
    if not os.path.isfile(path):
        raise argparse.ArgumentTypeError(f"file {path!r} does not exist")
    return path


def _existing_dir(path: str) -> str:
    if not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"directory {path!r} does not exist")
    return path


def _existing_path(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def diff(jplace1: str, jplace2: str, only_best: bool = False) -> int:
    """Semantic diff of two jplace files (the parity oracle, reference:
    scripts/jplace_diff.py); 1 when they differ."""
    from ..tools.jplace_diff import jplace_diff

    res = jplace_diff(jplace1, jplace2, only_best=only_best)
    for m in res.mismatches[:200]:
        print(m)
    print(f"\n{res.num_matches}/{res.num_seqs} placements match.")
    return 0 if res.clean else 1


def probe(database: str) -> int:
    """Diagnose an .ipk file's layout (``io/ipk_boost.py::probe_ipk``)."""
    from ..io.ipk_boost import probe_ipk

    print(probe_ipk(database))
    return 0


def convert(src: str, dst: str) -> int:
    """Convert a database between .ipk (the reconstructed Boost layout,
    unverified: ``io/ipk_boost.py``) and the native .eptk format."""
    from ..io.db import save
    from ..io.ipk_boost import UnverifiedFormatError, read_ipk, write_ipk

    if src.endswith(".eptk"):
        db = load(src)
    else:
        try:
            db = read_ipk(src)
        except UnverifiedFormatError as e:
            _err(f"Error reading {src}: {e}")
            _err("Note: the .ipk reader implements a reconstructed layout; the "
                 "i2l serialization source was unavailable. Re-export with IPK "
                 "or use .eptk.")
            return 1
    if dst.endswith(".ipk"):
        write_ipk(db, dst)
    else:
        save(db, dst)
    print(f"Converted {src} -> {dst}: {db.num_kmers} k-mers, "
          f"{db.num_entries} entries, k={db.kmer_size}, {db.sequence_type}")
    return 0


def stats(database: str) -> int:
    """Print database parameters (the reference binary's stdout block, reference:
    main.cpp:285-292) without placing anything."""
    from ..core.tree import parse_newick

    db = load(database)
    print("Database parameters:")
    print(f"\tSequence type: {db.sequence_type}")
    print(f"\tk: {db.kmer_size}")
    print(f"\tomega: {db.omega:g}")
    print(f"\tPositions loaded: {'true' if db.positions_loaded else 'false'}")
    print(f"\tk-mers: {db.num_kmers}")
    print(f"\tEntries: {to_human_readable(db.get_num_entries_total())}")
    print(f"\tMax posting list: {db.max_posting_len()}")
    tree = parse_newick(db.tree())
    print(f"\tTree: {len(tree.leaves())} leaves, {tree.get_node_count()} nodes")
    return 0


def build_db(tree_file: str, entries_file: str, kmer_size: int, omega: float, states: str,
             output: str) -> int:
    """Build a .eptk database from explicit phylo-k-mer scores (a JSON file
    ``{kmer: [[branch, log10_score], ...], ...}`` and a newick tree)."""
    import json

    from ..io.build import build_db as build
    from ..io.db import save

    with open(entries_file) as f:
        raw = json.load(f)
    entries = {k: [(int(b), float(sc)) for b, sc in v] for k, v in raw.items()}
    with open(tree_file) as f:
        newick = f.read().strip()
    db = build(entries, newick, kmer_size=kmer_size, omega=omega, sequence_type=states)
    save(db, output)
    print(f"Wrote {output}: {db.num_kmers} k-mers, {db.num_entries} entries")
    return 0


def ppdiff(config: str | None, workdir: str | None) -> int:
    """Two-implementation differential harness (``tools/ppdiff.py``), on
    the card."""
    from ..tools.ppdiff import main as ppdiff_main

    args = ["--workdir", workdir] if workdir else []
    if config:
        args += ["--config", config]
    return ppdiff_main(args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="epik_tpu_torch",
        description="EPIK on PyTorch/CUDA: Evolutionary Placement with "
                    "Informative K-mers.")
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("place", help="Places .fasta files using the input "
                                     "phylo-k-mer database.")
    p.add_argument("-i", "-d", "--database", required=True, type=_existing_file,
                   help="Input database.")
    p.add_argument("-s", "--states", choices=["nucl", "amino"], default="nucl",
                   help="States used in analysis. [default: nucl]")
    p.add_argument("--omega", type=float, default=1.5,
                   help="User omega value, determines the score threshold.")
    p.add_argument("--mu", type=float, default=1.0,
                   help="The proportion of the database to keep.")
    p.add_argument("-o", "--outputdir", required=True, type=_existing_dir,
                   help="Output directory.")
    p.add_argument("-j", "--threads", type=int, default=1,
                   help="Host worker threads for tokenization. [default: 1]")
    p.add_argument("--max-ram", type=str, default="",
                   help="Approximate RAM limit to use. Database may not be fully loaded")
    p.add_argument("--batch-size", type=int, default=2000,
                   help="Batch size (reads per device step). [default: 2000]")
    p.add_argument("--keep-at-most", type=int, default=7,
                   help="Number of branches to report. [default: 7]")
    p.add_argument("--keep-factor", type=float, default=0.01,
                   help="Minimum LWR to report. [default: 0.01]")
    p.add_argument("--engine", choices=["torch", "sharded", "native", "reference"],
                   default="torch",
                   help="Placement engine: the single-device torch placer, the "
                        "multi-device sharded engine, the native C++ CPU placer (-j "
                        "threads, no device needed), or the scalar oracle. "
                        "[default: torch]")
    p.add_argument("--n-model", type=int, default=1,
                   help="Model-axis shards for --engine sharded (the database sharded "
                        "by branch columns or key hash when > 1); the remaining devices "
                        "go data-parallel. [default: 1]")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="Torch device to place on. [default: cuda]")
    p.add_argument("--inflight", type=int, default=3,
                   help="Batches placed concurrently. [default: 3]")
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted run: keep complete placements in "
                        "the existing output file and continue from the next read.")
    p.add_argument("--verbose", action="store_true",
                   help="Print the pipeline stage-time breakdown.")
    p.add_argument("--precision", choices=["exact", "int16", "bf16"], default="exact",
                   help="Dense-plane storage: exact f32, int16 (quantized shifted plane, "
                        "exact int32 sums) or bf16 (classic plane, outside the 1e-4 "
                        "gate). [default: exact]")
    p.add_argument("--plane-mode", choices=["shifted", "classic"], default="shifted",
                   help="Dense scoring formulation: shifted (one sum per window) or "
                        "classic (sums and counts). [default: shifted]")
    p.add_argument("--pair-plane", choices=["auto", "on", "off"], default="auto",
                   help="(k+1)-mer pair plane: auto (when it fits), on (or fail), off. "
                        "[default: auto]")
    p.add_argument("--tile-payload", choices=["auto", "packed", "f32"], default="auto",
                   help="Posting-tile cell layout (the big-tree path): packed int32 "
                        "(branch<<16 | quantized score; half the gather bytes) or "
                        "bit-exact f32 pairs. [default: auto]")
    p.add_argument("--profile-dir", default=None,
                   help="Record the run with torch.profiler (the host and the card's "
                        "kernels) into a Chrome trace in this directory.")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process: coordinator address host:port (rank 0 serves it); "
                        "requires --num-processes and --process-id.")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process: total process count.")
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-process: this process's rank.")
    p.add_argument("--collective-timeout", type=float, default=300.0,
                   help="Multi-process: seconds a batch may stall before the watchdog "
                        "exits the process (code 42) for supervised restart (resume "
                        "from the jplace sidecar with --resume). [default: 300.0]")
    p.add_argument("input_file", type=_existing_file)
    p.set_defaults(run=lambda a: place_queries(
        a.database, a.states, a.omega, a.mu, a.outputdir, a.threads, a.max_ram,
        a.input_file, batch_size=a.batch_size, keep_at_most=a.keep_at_most,
        keep_factor=a.keep_factor, resume=a.resume, verbose=a.verbose,
        inflight=a.inflight, precision=a.precision, plane_mode=a.plane_mode,
        pair_plane=a.pair_plane, tile_payload=a.tile_payload, platform=a.platform,
        engine=a.engine, n_model=a.n_model, profile_dir=a.profile_dir,
        coordinator=a.coordinator, num_processes=a.num_processes,
        process_id=a.process_id, collective_timeout=a.collective_timeout))

    p = sub.add_parser("diff", help="Semantic diff of two jplace files.")
    p.add_argument("jplace1", type=_existing_path)
    p.add_argument("jplace2", type=_existing_path)
    p.add_argument("--only-best", action="store_true")
    p.set_defaults(run=lambda a: diff(a.jplace1, a.jplace2, a.only_best))

    p = sub.add_parser("probe", help="Diagnose an .ipk file's layout.")
    p.add_argument("database", type=_existing_path)
    p.set_defaults(run=lambda a: probe(a.database))

    p = sub.add_parser("convert", help="Convert a database between .ipk and .eptk.")
    p.add_argument("src", type=_existing_path)
    p.add_argument("dst")
    p.set_defaults(run=lambda a: convert(a.src, a.dst))

    p = sub.add_parser("stats", help="Print database parameters.")
    p.add_argument("database", type=_existing_path)
    p.set_defaults(run=lambda a: stats(a.database))

    p = sub.add_parser("build-db", help="Build a .eptk database from explicit "
                                        "phylo-k-mer scores.")
    p.add_argument("--tree", dest="tree_file", required=True, type=_existing_path,
                   help="Reference tree (newick).")
    p.add_argument("--entries", dest="entries_file", required=True, type=_existing_path,
                   help="JSON file: {kmer: [[branch, log10_score], ...], ...}.")
    p.add_argument("-k", "--kmer-size", type=int, required=True)
    p.add_argument("--omega", type=float, default=1.5, help="[default: 1.5]")
    p.add_argument("-s", "--states", choices=["nucl", "amino"], default="nucl",
                   help="[default: nucl]")
    p.add_argument("output")
    p.set_defaults(run=lambda a: build_db(a.tree_file, a.entries_file, a.kmer_size, a.omega,
                                          a.states, a.output))

    p = sub.add_parser("ppdiff", help="Two-implementation differential harness.")
    p.add_argument("--config", type=_existing_path, default=None,
                   help="JSON case config (default: built-in cases)")
    p.add_argument("--workdir", default=None,
                   help="[default: epik_tpu_torch_ppdiff in the temporary directory]")
    p.set_defaults(run=lambda a: ppdiff(a.config, a.workdir))
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.run(args)
