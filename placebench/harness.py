"""One run of one cell: set-up, the measured window, the check, the result.

The harness does what ``epik place`` does, from its own files: the port's
``run_pipeline`` over a ``TorchPlacer`` built as the CLI builds ``--engine
torch``, reading with the port's native FASTA reader and writing with its
jplace writer. It wraps the three without changing them: the reader wrapper
stamps each batch it hands out and ends the window, the placer wrapper stamps
each ``place`` call, the writer wrapper stamps each write and the bytes it
added.

* Set-up: the database arrays from the frozen generator (``gen.py``), handed
  to the port's ``PhyloKmerDB``; the placer builds its plane on the device;
  the read pool is written under ``TMPDIR``; a warm-up places a few pool
  batches through the same pipeline.
* The window starts when the first batch is handed out. After ``seconds``
  the reader hands out no more; the batches in flight drain, and the window
  ends at the last batch's write. The pool is read again and again, each pass
  tagging its read names with the pass number (``r<i>.p<pass>``); the placer
  keeps no state between batches, so a pass costs what the first did.
* The measured window runs under a profiler of the card alone (no host
  events), whose trace gives the card's busy time a read: the end-to-end
  ``card_ms_per_kread``. Its device events are the window's own, since the
  profiler starts after the warm-up's last sync and stops after the
  window's.
* A traced run then places a second window under the full profiler (every
  host thread and the card), of the same length up to ``TRACE_SECONDS``. The
  device's per-layer metrics come from that one; the host-clock metrics and
  the check from the first, which no host profiler slows. In a traced run
  both windows also record the interpreter's garbage collections
  (``gc.callbacks``); an untraced run records none.
* After the windows: the device's peak memory is read, the placer freed, and
  sampled reads of the first window's jplace held to the NumPy reference
  (``compare.py``).

A configuration, a traffic mix, a cell's limits and a per-layer metric are
each a file found by its name (``configs/``, ``traffic/``, ``cells/``,
``metrics/``); nothing here names one.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from . import compare, gen, trace
from .reference import ReferencePlacer

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "epik_tpu")

#: the traced window's longest length: the device's readings repeat to a few
#: tenths of a percent, and the profiler's trace grows with the window
TRACE_SECONDS = 20.0


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, compared whole
    (``epik_tpu_torch`` passes)."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def set_cache_dirs(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels under ``build/`` by itself)."""
    cache = root / "build" / "placebench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


@dataclasses.dataclass
class Spec:
    """A cell as its files give it."""

    dir: Path  # the benchmark's folder: paths[0] of BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    per_layer: list[dict]
    end_to_end: list[dict]


def load_spec(root: Path, name: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    folder = root / bench["paths"][0]
    traffic = json.loads((folder / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((folder / "cells" / f"{name}.json").read_text())["limits"]

    def here(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Spec(folder, cell, config, traffic, limits, [m for m in bench["per_layer"] if here(m)],
                [m for m in bench["end_to_end"] if here(m)])


def seeds(seed: int) -> dict[str, np.random.SeedSequence]:
    """Independent streams of one ``--seed`` (any whole number)."""
    root = np.random.SeedSequence(seed % (1 << 64))
    db, reads, sample = root.spawn(3)
    return {"db": db, "reads": reads, "sample": sample}


class PoolReader:
    """Hands out the pool's batches through the port's reader until the
    window's time is up (or ``max_batches`` are out); reopens the pool at its
    end."""

    def __init__(self, open_reader, path: str, batch: int, seconds: float = math.inf,
                 max_batches: int | None = None):
        self._open = open_reader
        self._path, self._batch, self._seconds = path, batch, seconds
        self._max = max_batches
        self._reader = open_reader(path, batch)
        self.passes = 0
        self.t_start: float | None = None
        self.read_spans: list[tuple[float, float]] = []
        #: per batch handed out: (pass, index of its first pool read, reads)
        self.batches: list[tuple[int, int, int]] = []

    def next_batch(self):
        t0 = time.monotonic()
        if ((self.t_start is not None and t0 - self.t_start >= self._seconds)
                or len(self.batches) == self._max):
            return []
        batch = self._reader.next_batch()
        if not batch:
            self._reader.close()
            self.passes += 1
            self._reader = self._open(self._path, self._batch)
            batch = self._reader.next_batch()
        t1 = time.monotonic()
        self.read_spans.append((t0, t1))
        if self.t_start is None:
            self.t_start = t1
        tag = f".p{self.passes}"
        self.batches.append((self.passes, int(batch[0][0][1:]), len(batch)))
        return [(name + tag, seq) for name, seq in batch]

    def bytes_read(self) -> int:
        return 0

    def close(self):
        self._reader.close()


class TimedPlacer:
    """Stamps each ``place`` call; keeps its start for the batch's write."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: list[tuple[float, float]] = []
        #: the start of each call, by the id of what it returned
        self.started: dict[int, list[tuple[float, object]]] = {}
        self._lock = threading.Lock()

    def place(self, batch):
        t0 = time.monotonic()
        placed = self.inner.place(batch)
        t1 = time.monotonic()
        with self._lock:
            self.spans.append((t0, t1))
            self.started.setdefault(id(placed), []).append((t0, placed))
        return placed


class GcPauses:
    """The interpreter's garbage collections while it is registered in
    ``gc.callbacks``: (start, end, generation) on the monotonic clock."""

    def __init__(self):
        self.spans: list[tuple[float, float, int]] = []
        self._t: float | None = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.spans.append((self._t, time.monotonic(), info["generation"]))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


class TimedWriter:
    """Stamps each write and the byte range it appended."""

    def __init__(self, inner, path: str, placer: TimedPlacer):
        self.inner, self.path, self.placer = inner, path, placer
        self.pos = os.path.getsize(path)
        #: per batch written: (place start, write start, write end, first
        #: byte, end byte, reads)
        self.writes: list[tuple[float, float, float, int, int, int]] = []

    def __lshift__(self, placed):
        t0 = time.monotonic()
        self.inner << placed
        t1 = time.monotonic()
        end = os.path.getsize(self.path)
        with self.placer._lock:
            pending = self.placer.started[id(placed)]
            start, _ = pending.pop(0)
            if not pending:
                del self.placer.started[id(placed)]
        n = sum(len(h) for h in placed.sequence_map.values())
        self.writes.append((start, t0, t1, self.pos, end, n))
        self.pos = end
        return self


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/<name>.py``).

    ``window``, ``spans``, ``stats`` and ``batches`` are the measured
    window's, which no profiler slows; ``trace`` and ``traced_batches`` the
    traced window's (None and empty in an untraced run). ``spans`` holds
    ``"gc"``, the collections (start, end, generation), in a traced run
    alone. ``written`` is the reads the measured window wrote."""

    window: tuple[float, float]
    spans: dict[str, list[tuple[float, float]]]
    stats: object
    batches: list[tuple[int, int, int]]
    trace: dict | None
    traced_batches: list[tuple[int, int, int]]
    device_name: str
    pool: tuple[np.ndarray, np.ndarray]
    db: dict
    K: int
    notes: list[str]
    written: int = 0


def read_metric(folder: Path, name: str, run: Run):
    """The per-layer metric ``name`` from its reader, ``metrics/<name>.py``'s
    ``read(run)`` in the benchmark's ``folder``; None where the reader finds
    nothing to read."""
    path = folder / "metrics" / f"{name}.py"
    module = "placebench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _make_db(config: dict, seq: np.random.SeedSequence) -> dict:
    g = config["generator"]
    return gen.reference_like_db(g["num_leaves"], g["kmer_size"], g["ref_length"],
                                 g["mean_posting_len"], g["omega"],
                                 seed=int(seq.generate_state(1, np.uint64)[0]))


def _write_pool(path: str, db: dict, traffic: dict, rng: np.random.Generator):
    n = traffic["batch"] * traffic["pool_batches"]
    buf, off, iupac = gen.make_reads(db["ref"], n, tuple(traffic["lengths"]),
                                     traffic["divergence"], traffic["iupac_share"],
                                     tuple(traffic["iupac_per_read"]), rng)
    with open(path, "wb") as f:
        f.write(gen.fasta_bytes(buf, off))
    return buf, off, iupac


def _sample(writes, batches, traffic, iupac, rng) -> dict[int, list[int]]:
    """Batch j -> pool reads to check: the first and the last batch and
    others drawn from the seed, from at least two passes where the window
    made two, each with reads drawn from the seed and all its IUPAC reads."""
    n_w = len(writes)
    want = min(n_w, traffic["check"]["batches"])
    picked = {0, n_w - 1}
    rest = [j for j in rng.permutation(n_w).tolist() if j not in picked]
    picked.update(rest[:max(0, want - len(picked))])
    passes = {batches[j][0] for j in picked}
    if len(passes) < 2:
        other = [j for j in range(n_w) if batches[j][0] not in passes]
        if other:
            picked.add(other[int(rng.integers(len(other)))])
    out = {}
    for j in sorted(picked):
        _, first, n = batches[j]
        chosen = set((first + rng.choice(n, size=min(n, traffic["check"]["reads"]),
                                         replace=False)).tolist())
        chosen.update(int(i) for i in iupac[(iupac >= first) & (iupac < first + n)])
        out[j] = sorted(chosen)
    return out


def _check(path: str, db: dict, pool: tuple, batches: list, writes: list, placer_cfg: dict,
           traffic: dict, rng: np.random.Generator) -> dict:
    """The compared numbers of the jplace at ``path`` (``compare.py``)."""
    buf, off, iupac = pool
    sample = _sample(writes, batches, traffic, iupac, rng)
    ranges, names, reads = {}, {}, {}
    for j, pool_idx in sample.items():
        p, first, n = batches[j]
        ranges[j] = (writes[j][3], writes[j][4], [f"r{i}.p{p}" for i in range(first, first + n)])
        names[j] = [f"r{i}.p{p}" for i in pool_idx]
        for i in pool_idx:
            reads[f"r{i}.p{p}"] = buf[off[i]:off[i + 1]].tobytes()
    ref = ReferencePlacer(db, placer_cfg["keep_at_most"], placer_cfg["keep_factor"])
    numbers = compare.check_sample(path, ranges, names, reads, ref, placer_cfg["keep_factor"])
    if not compare.file_is_closed(path):
        numbers["missing"] += 1
    return numbers


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None, config_overrides=None,
             wrap_placer=None, log=print) -> dict:
    """One run; returns the result line as a dict (``correct`` and all).

    ``config_overrides`` replace ``PlacerConfig`` fields (the control);
    ``wrap_placer`` wraps the port's placer before the window (the tests'
    faults); ``log`` takes the lines for standard error.
    """
    t_start = time.monotonic() if t_start is None else t_start
    spec = load_spec(root, workload)
    import torch

    from epik_tpu_torch import native
    from epik_tpu_torch.core.tree import parse_newick, to_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.pipeline import run_pipeline
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.db import EARLIEST_INDEX, PhyloKmerDB
    from epik_tpu_torch.io.jplace import jplace_writer

    cuda = device == "cuda"
    marks = [("start", t_start), ("imports", time.monotonic())]
    streams = seeds(seed)
    cfg, traffic = spec.config, spec.traffic
    work = Path(tempfile.mkdtemp(prefix="placebench."))
    try:
        db = _make_db(cfg, streams["db"])
        marks.append(("database", time.monotonic()))
        n_entries = int(db["branches"].size)
        # the port gets copies: the reference reads the harness's arrays alone
        pdb = PhyloKmerDB(sequence_type="nucl", kmer_size=db["kmer_size"], omega=db["omega"],
                          tree_newick=db["newick"], keys=db["keys"].copy(),
                          row_off=db["row_off"].copy(), branches=db["branches"].copy(),
                          scores=db["scores"].copy(), version=EARLIEST_INDEX,
                          num_entries_total=n_entries, num_entries_loaded=n_entries)
        tree = parse_newick(pdb.tree())
        pcfg = dict(cfg["placer"]["config"], **(config_overrides or {}))
        placer = TorchPlacer(pdb, tree, keep_at_most=cfg["placer"]["keep_at_most"],
                             keep_factor=cfg["placer"]["keep_factor"],
                             config=PlacerConfig(**pcfg), device=device)
        if cfg.get("route") and placer.route != cfg["route"]:
            raise RuntimeError(f"the placer took the {placer.route} route, not {cfg['route']}")
        if cuda:
            torch.cuda.synchronize()
        marks.append(("plane", time.monotonic()))
        inner = wrap_placer(placer) if wrap_placer else placer
        pool_path = str(work / "pool.fasta")
        buf, off, iupac = _write_pool(pool_path, db, traffic,
                                      np.random.default_rng(streams["reads"]))
        if native.load_native() is None:
            raise RuntimeError("the port's native host library did not load")
        open_reader = native.NativeFastaReader
        marks.append(("pool", time.monotonic()))
        newick = to_newick(tree, jplace_edges=True)
        invocation = f"placebench {workload} --seed {seed}"

        # warm-up: the cell's own batches through the same pipeline
        warm = PoolReader(open_reader, pool_path, traffic["batch"],
                          max_batches=traffic["warmup_batches"])
        wpath = str(work / "warmup.jplace")
        wwriter = jplace_writer(wpath, invocation, newick)
        wwriter.start()
        run_pipeline(inner, warm, wwriter, inflight=traffic["inflight"])
        wwriter.end()
        warm.close()
        os.remove(wpath)
        if cuda:
            torch.cuda.synchronize()

        def window(path, length):
            writer = jplace_writer(path, invocation, newick)
            writer.start()
            reader = PoolReader(open_reader, pool_path, traffic["batch"], length)
            timed = TimedPlacer(inner)
            twriter = TimedWriter(writer, path, timed)
            pauses = GcPauses()
            if traced:
                with pauses:
                    stats = run_pipeline(timed, reader, twriter, inflight=traffic["inflight"])
            else:
                stats = run_pipeline(timed, reader, twriter, inflight=traffic["inflight"])
            if cuda:
                torch.cuda.synchronize()
            writer.end()
            reader.close()
            spans = {"read": list(reader.read_spans), "place": list(timed.spans),
                     "write": [(w[1], w[2]) for w in twriter.writes],
                     "batch": [(w[0], w[2]) for w in twriter.writes]}
            if traced:
                spans["gc"] = pauses.spans
            return reader, twriter, stats, spans

        out_path = str(work / "placements.jplace")
        if cuda:
            card_path = str(work / "card.json")
            card_prof = trace.start_profiler(torch, cuda, host=False)
        reader, twriter, stats, spans = window(out_path, seconds)
        if cuda:
            trace.stop_profiler(torch, card_prof, card_path, cuda)
            card_busy_s, n_card = trace.busy_seconds(trace.load_events(card_path))
            os.remove(card_path)
            if n_card == 0:
                raise RuntimeError("the card's trace of the window holds no device event")
        w0 = reader.t_start
        w1 = twriter.writes[-1][2]
        setup_s = w0 - t_start
        marks.append(("warm-up", w0))
        log("setup: " + ", ".join(f"{name} {b - a:.3f} s"
                                  for (_, a), (name, b) in zip(marks, marks[1:])))
        if traced:
            trace_path = str(work / "trace.json")
            prof = trace.start_profiler(torch, cuda)
            mark = trace.clock_mark(torch)
            t_reader, t_writer, _, t_spans = window(str(work / "traced.jplace"),
                                                    min(seconds, TRACE_SECONDS))
            trace.stop_profiler(torch, prof, trace_path, cuda)
            os.remove(work / "traced.jplace")
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
        handed = sum(b[2] for b in reader.batches)
        written = sum(w[5] for w in twriter.writes)
        e2e = {"setup_s": setup_s}
        if cuda:
            e2e["card_ms_per_kread"] = 1e6 * card_busy_s / written
        log(f"window {w1 - w0:.3f} s, {len(twriter.writes)} batches, {written} reads "
            f"({written / (w1 - w0):.1f} a second), {reader.passes + 1} pool passes, "
            f"{twriter.pos / 2**20:.1f} MiB of jplace, setup {setup_s:.3f} s, "
            f"route {placer.route}"
            + (f", card busy {card_busy_s:.4f} s ({n_card} device events)" if cuda else ""))

        # the program's state goes before the reference runs
        twriter.placer = None
        if traced:
            t_writer.placer = None
        inner = placer = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_check = time.monotonic()
        numbers = _check(out_path, db, (buf, off, iupac), reader.batches, twriter.writes,
                         cfg["placer"], traffic, np.random.default_rng(streams["sample"]))
        numbers["lost_reads"] = handed - written
        log(f"check: {numbers['reads_checked']} reads, {time.monotonic() - t_check:.3f} s")
        checks = {k: {"value": numbers[k], "limit": lim} for k, lim in spec.limits.items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())

        result = {"correct": correct, "attempted": handed, "failed": handed - written}
        metrics = {}
        summary = None
        if traced:
            if cuda:
                layers = {k: [s[:2] for s in t_spans[k]]
                          for k in ("read", "place", "write", "gc")}
                summary = trace.reduce_trace(trace.load_events(trace_path), mark,
                                             (t_reader.t_start, t_writer.writes[-1][2]), layers)
                if summary is None:
                    raise RuntimeError("the trace holds no clock marker")
            run = Run(window=(w0, w1), spans=spans, stats=stats, batches=reader.batches,
                      trace=summary, traced_batches=t_reader.batches, device_name=device_name,
                      pool=(buf, off), db=db, K=cfg["placer"]["keep_at_most"], notes=[],
                      written=written)
            for m in spec.per_layer:
                value = read_metric(spec.dir, m["name"], run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            for note in run.notes:
                log(note)
        else:
            for m in spec.end_to_end:
                if m["name"] in e2e:  # the card's metric needs a card
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
        dev = {"platform": "gpu" if cuda else "cpu", "kind": device_name,
               "count": int(spec.workload["chips"]), "memory_peak_bytes": peak}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
        result["device"] = dev
        if summary is not None:
            result["breakdown"] = {
                "device_ops": [[name[:160], s] for name, s in
                               sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [list(g) for g in summary["gaps"][:10]],
            }
        result["numbers"] = numbers  # every number, compared or not (run.py drops it)
        result["checks"] = checks
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules of JAX or the JAX package are loaded: {found}")
        self.found = found

