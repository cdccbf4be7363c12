"""Command-line interface of the port: ``python -m epik_tpu_torch place``.

The ``place`` command of ``epik_tpu/cli/main.py`` (:42-386) with the flags the
ported path runs, on ``argparse`` (the port does not depend on click), and
``--platform cuda|cpu`` in place of the JAX platform flag. It loads the
database, builds a :class:`~epik_tpu_torch.engine.placer.TorchPlacer`, streams
the FASTA through ``engine.pipeline.run_pipeline`` into the jplace
writer, and prints the same lines as the JAX CLI to the same
``placements_<input>.jplace``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..io.db import PKDB_VALUE_SIZE, load
from ..io.fasta import batch_fasta
from ..io.jplace import jplace_writer
from ..utils.progress import (
    ProgressBar,
    humanize_time,
    parse_human_readable,
    to_human_readable,
)

from .. import __version__

__all__ = ["main", "make_invocation", "make_output_filename", "place_queries"]


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
                  tile_payload="auto", platform="cuda") -> int:
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

    import torch

    from ..core.tree import parse_newick, to_newick
    from ..engine.config import PlacerConfig
    from ..engine.pipeline import run_pipeline
    from ..engine.placer import TorchPlacer

    tree = parse_newick(db.tree())
    cfg = PlacerConfig(host_threads=max(1, threads), precision=precision,
                       plane_mode=plane_mode, pair_plane=pair_plane,
                       tile_payload=tile_payload)
    placer = TorchPlacer(db, tree, keep_at_most=keep_at_most,
                         keep_factor=keep_factor, config=cfg, device=platform)
    n_dev = torch.cuda.device_count() if placer.device.type == "cuda" else 1
    engine_name = f"torch/{placer.device.type} ({n_dev} device(s), {placer.route})"

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

    stats = run_pipeline(placer, reader, writer, progress=progress, inflight=inflight)
    writer.end()
    if verbose:
        print(f"Pipeline: {stats.summary()}")

    bar.update(reader.bytes_read(), prefix="Done. ",
               postfix=to_human_readable(stats.num_seq_placed))
    bar.finish()

    print(f"Placed {stats.num_seq_placed} sequences.\n"
          f"Average speed: {to_human_readable(stats.average_speed)} seq/s.")
    print(f"Output: {jplace_filename}")
    placement_time = int((time.monotonic() - begin) * 1000)
    print(f"Placement time: {humanize_time(placement_time)} ({placement_time} ms)")
    print("Done.")
    return 0


def _existing_file(path: str) -> str:
    if not os.path.isfile(path):
        raise argparse.ArgumentTypeError(f"file {path!r} does not exist")
    return path


def _existing_dir(path: str) -> str:
    if not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"directory {path!r} does not exist")
    return path


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
    p.add_argument("input_file", type=_existing_file)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return place_queries(
        args.database, args.states, args.omega, args.mu, args.outputdir,
        args.threads, args.max_ram, args.input_file,
        batch_size=args.batch_size, keep_at_most=args.keep_at_most,
        keep_factor=args.keep_factor, resume=args.resume, verbose=args.verbose,
        inflight=args.inflight, precision=args.precision,
        plane_mode=args.plane_mode, pair_plane=args.pair_plane,
        tile_payload=args.tile_payload, platform=args.platform,
    )
