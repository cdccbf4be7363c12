"""The traced run: ``torch.profiler`` over the window, and its Chrome trace
reduced to the device's busy time, kernel time by name and idle gaps.

Device time is every kernel, memcpy and memset event of the trace. The
window and the harness's spans are mapped onto the trace's clock by one
``record_function`` marker opened at a known ``time.monotonic()``.
"""

from __future__ import annotations

import json
import re
import time

CLOCK_MARK = "placebench.clock"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start_profiler(torch, cuda: bool, host: bool = True):
    """A started profiler: over every thread of the host (the pipeline places
    on worker threads) where ``host``, and the card where ``cuda``; raises
    where it cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU] if host else []
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("this torch cannot trace CUDA kernels")
        activities.append(ProfilerActivity.CUDA)
    config = {}
    if host:
        config["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    prof = profile(activities=activities, acc_events=True, **config)
    prof.start()
    if cuda:
        torch.cuda.synchronize()
    return prof


def clock_mark(torch) -> float:
    """Open and close the marker; returns the monotonic time it opened at."""
    t = time.monotonic()
    with torch.profiler.record_function(CLOCK_MARK):
        pass
    return t


def stop_profiler(torch, prof, path: str, cuda: bool) -> str:
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    return path


def kernel_name(name: str) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::`` and its
    argument list (the first ``(`` outside template brackets)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i].strip()
    return name.strip()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_intervals(events: list[dict]) -> list[tuple[float, float]]:
    """Every kernel, memcpy and memset of a Chrome trace, (start, end) in its
    microseconds."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_seconds(events: list[dict]) -> tuple[float, int]:
    """The seconds in which the card ran anything, over the whole trace, and
    the number of device events: for a trace that the profiler took over one
    window and nothing else, so that no clock mapping is needed."""
    spans = device_intervals(events)
    return sum(b - a for a, b in _union(spans)) * 1e-6, len(spans)


def reduce_trace(events: list[dict], mark_mono: float, window: tuple[float, float],
                 spans: dict[str, list[tuple[float, float]]], top: int = 10) -> dict | None:
    """The window's device busy time, kernel time by name and idle gaps.

    ``events``: the Chrome trace's ``traceEvents``; ``mark_mono`` the
    monotonic time :func:`clock_mark` returned; ``window`` and ``spans``
    (name -> intervals) in monotonic seconds. Returns None without the
    marker, else ``{"busy_s", "window_s", "ops": {name: s}, "gaps": [(label,
    s)], "n_device_events"}``: the ``top`` longest gaps, each labelled by
    the spans open at its middle ("+"-joined, "none" where none was).
    """
    marks = [e for e in events if e.get("name") == CLOCK_MARK and "ts" in e]
    if not marks:
        return None
    offset = float(marks[0]["ts"]) - mark_mono * 1e6  # trace us - monotonic us
    w0, w1 = window[0] * 1e6 + offset, window[1] * 1e6 + offset
    busy, ops = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        name = kernel_name(e.get("name", "?")) if e["cat"] == "kernel" else e.get("name", "?")
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    holes = []
    edge = w0
    for a, b in merged + [(w1, w1)]:
        if a > edge:
            holes.append((a - edge, edge, a))
        edge = max(edge, b)
    holes.sort(key=lambda h: -h[0])
    mapped = {k: [(a * 1e6 + offset, b * 1e6 + offset) for a, b in v] for k, v in spans.items()}
    gaps = []
    for length, a, b in holes[:top]:
        mid = (a + b) / 2
        label = "+".join(k for k in sorted(mapped)
                         if any(s <= mid <= t for s, t in mapped[k])) or "none"
        gaps.append((label, length * 1e-6))
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6, "ops": ops, "gaps": gaps,
            "n_device_events": len(busy)}


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])
