"""Spans and counters inside the port: where a batch's time goes on the host.

The recorder is off by default. While it is off, :func:`span` returns one
shared no-op context manager after one module-global check, and :func:`note`
and :func:`add` return at once, so the hot path allocates nothing.

:func:`enable` turns it on. Each span then records its name, its batch id (the
sequence number ``run_pipeline`` gives a batch when the reader hands it out,
inherited by the spans opened inside it on the same thread), its thread, its
parent (the span open around it on that thread), its start and end on
``time.monotonic_ns()`` and the thread's CPU time over it
(``time.thread_time_ns()``): wall minus CPU is the time the thread spent off
the CPU, waiting for the interpreter lock, the device or the host's cores.
Where the thread clock moves in coarse steps (10 ms on some virtual
machines), one span's CPU time is a sample, meaningful summed over many.
Counters are attributes of the innermost open span (:func:`note`,
:func:`add`). Spans are kept in memory and handed over by :func:`drain`, or,
where :func:`enable` is given a sink such as :meth:`Tally.add`, handed to it
as they close: a :class:`Tally` keeps a run's totals in bounded memory, for
``place --verbose``.

While a ``torch.profiler`` runs, each span also opens
``torch.profiler.record_function(name)``, so the profiler's trace shows the
port's ranges beside the kernels on its own clock. While the recorder is on,
one ``gc.callbacks`` entry records each collection as a ``gc`` span (with its
``generation``) on the thread that ran it.
"""

from __future__ import annotations

import gc
import random
import threading
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["Span", "Tally", "add", "disable", "drain", "enable", "enabled", "note", "span"]

_on = False
_recorded: list[Span] = []
_sink = _recorded.append  # takes each span as it closes


class _Stack(threading.local):
    def __init__(self):
        self.open: list[Span] = []


_stack = _Stack()


class _Off:
    """The span while the recorder is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span; ``start``/``end`` in monotonic ns, ``cpu`` the
    thread's CPU ns over it, ``attrs`` its counters (None without any)."""

    __slots__ = ("name", "batch", "thread", "parent", "start", "end", "cpu", "attrs", "_range")

    def __init__(self, name: str, batch: int | None):
        self.name, self.batch, self.attrs, self._range = name, batch, None, None

    def __enter__(self):
        self._open(_profiler._is_profiler_enabled)
        return self

    def __exit__(self, *exc):
        self._close()
        return False

    def _open(self, profiled: bool) -> None:
        stack = _stack.open
        if stack and stack[-1].name == "gc":
            stack.pop()  # a collection that ended while the recorder was off
        self.parent = stack[-1] if stack else None
        if self.batch is None and self.parent is not None:
            self.batch = self.parent.batch
        self.thread = threading.get_ident()
        stack.append(self)
        if profiled:
            self._range = record_function(self.name)
            self._range.__enter__()
        # the CPU clock is read inside the wall clock's interval: cpu <= wall
        self.start = time.monotonic_ns()
        self.cpu = time.thread_time_ns()

    def _close(self) -> None:
        self.cpu = time.thread_time_ns() - self.cpu
        self.end = time.monotonic_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _stack.open.pop()
        _sink(self)

    @property
    def wall(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, batch={self.batch}, wall={self.wall / 1e6:.3f} ms, "
                f"cpu={self.cpu / 1e6:.3f} ms, attrs={self.attrs})")


def span(name: str, batch: int | None = None):
    """A context manager timing ``name``; ``batch`` sets the span's batch id
    (else its parent's)."""
    if not _on:
        return _OFF
    return Span(name, batch)


def _top_attrs() -> dict | None:
    """The counters of this thread's innermost open span (None without one)."""
    stack = _stack.open
    if not stack:
        return None
    top = stack[-1]
    if top.attrs is None:
        top.attrs = {}
    return top.attrs


def note(key: str, value) -> None:
    """Set the counter ``key`` on the innermost open span of this thread."""
    if not _on:
        return
    attrs = _top_attrs()
    if attrs is not None:
        attrs[key] = value


def add(key: str, n: int) -> None:
    """Add ``n`` to the counter ``key`` of the innermost open span of this thread."""
    if not _on:
        return
    attrs = _top_attrs()
    if attrs is not None:
        attrs[key] = attrs.get(key, 0) + n


def _collection(phase: str, info: dict) -> None:
    stack = _stack.open
    if phase == "start":
        s = Span("gc", None)
        s.attrs = {"generation": info["generation"]}
        s._open(False)  # no profiler range: no torch call inside a collection
    elif stack and stack[-1].name == "gc":
        stack[-1]._close()


def enable(sink=None) -> None:
    """Turn the recorder on (and the collector's callback with it). ``sink``,
    where given, takes each span as it closes, in place of the list that
    :func:`drain` hands over."""
    global _on, _sink
    if not _on:
        _sink = _recorded.append if sink is None else sink
        gc.callbacks.append(_collection)
        _on = True


def disable() -> None:
    """Turn the recorder off; what it recorded stays until :func:`drain`."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_collection)


def enabled() -> bool:
    return _on


def drain() -> list[Span]:
    """The spans recorded so far, in the order they closed; the recorder
    forgets them."""
    out = _recorded[:]
    del _recorded[:len(out)]
    return out


def _p95(values: list[int]) -> int:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, (95 * len(ordered) + 99) // 100 - 1)]


class Tally:
    """The operator's view of a run's spans in bounded memory: for each span
    name its count, wall and CPU sums and a uniform sample of ``SAMPLE`` wall
    times (the 95th percentile is exact up to that count); the routes
    ``place`` took, the dense steps' gathers and the collections'
    generations, counted; the other counters' sums and largest values."""

    SAMPLE = 4096

    def __init__(self):
        self.names: dict[str, list] = {}  # name -> [count, wall ns, CPU ns, sample]
        # key -> value -> count
        self.labels: dict[str, dict] = {"route": {}, "gather": {}, "generation": {}}
        self.sums: dict[str, int] = {}
        self.peaks: dict[str, int] = {}
        self._draw = random.Random(0)

    def add(self, s: Span) -> None:
        wall = s.end - s.start
        entry = self.names.get(s.name)
        if entry is None:
            entry = self.names[s.name] = [0, 0, 0, []]
        entry[0] += 1
        entry[1] += wall
        entry[2] += s.cpu
        sample = entry[3]
        if len(sample) < self.SAMPLE:
            sample.append(wall)
        else:  # reservoir sampling: each span kept with the same chance
            j = self._draw.randrange(entry[0])
            if j < self.SAMPLE:
                sample[j] = wall
        if s.attrs:
            for key, value in s.attrs.items():
                counts = self.labels.get(key)
                if counts is not None:
                    counts[value] = counts.get(value, 0) + 1
                else:
                    self.sums[key] = self.sums.get(key, 0) + value
                    self.peaks[key] = max(self.peaks.get(key, value), value)

    def table(self) -> list[str]:
        """For each span name its count, mean and 95th-percentile wall ms and
        off-CPU share; then the routes, the dense steps' gathers, the
        collections by generation, the share of reads left after the dedup,
        the H2D bytes a batch, the sums the unfused gather wrote a batch and
        the budget retries."""
        width = max((len(name) for name in self.names), default=4)
        lines = [f"{'span':<{width}} {'count':>7} {'mean ms':>9} {'p95 ms':>9} {'off-CPU':>8}"]
        for name in sorted(self.names):
            n, wall, cpu, sample = self.names[name]
            off = 100.0 * (wall - cpu) / wall if wall else 0.0
            lines.append(f"{name:<{width}} {n:>7} {wall / n / 1e6:>9.3f} "
                         f"{_p95(sample) / 1e6:>9.3f} {off:>7.1f}%")
        for key, title in (("route", "routes"), ("gather", "gathers"),
                           ("generation", "collections, by generation")):
            if self.labels[key]:
                lines.append(f"{title}: " + ", ".join(
                    f"{v} {n}" for v, n in sorted(self.labels[key].items())))
        sums = self.sums
        reads = sums.get("reads")
        if reads:
            lines.append(f"dedup: {sums['distinct']} distinct of {reads} reads "
                         f"({100.0 * sums['distinct'] / reads:.1f}%)")
        batches = self.names.get("place.stage", [0])[0]
        if batches and "h2d_bytes" in sums:
            lines.append(f"H2D: {sums['h2d_bytes'] / batches / 1024:.1f} KiB a batch")
        gathers = self.labels["gather"]
        # the routes that write the sums and read them back (not fused, nor
        # posted_fused: those finish from shared memory)
        pairs = gathers.get("pair", 0) + gathers.get("posted", 0)
        if pairs and "sums_bytes" in sums:
            lines.append(f"sums written and read back: {sums['sums_bytes'] / pairs / 2**20:.3f} "
                         f"MiB a batch, largest {self.peaks['sums_bytes'] / 2**20:.3f}")
        retries = self.names.get("place.retry", [0])[0]
        if retries:
            amb = f", ambiguous {self.peaks['budget_amb']}" if "budget_amb" in self.peaks else ""
            lines.append(f"retries: {retries}, largest budget {self.peaks['budget']}{amb}")
        return lines
