"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 placebench/run.py --workload d652.illumina150 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. Exits with a nonzero code and prints no
result where CUDA has fewer cards than the cell asks for, where a module of
JAX or of the JAX package is loaded, or where the run fails.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the ``time.monotonic`` clock."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
def _io_counters() -> dict[str, int]:
    """This process's storage counters (Linux ``/proc/self/io``); empty
    where there are none."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (line.split(": ") for line in f if ": " in line)}
    except (OSError, ValueError):
        return {}


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    from placebench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    root = Path(ROOT)
    harness.set_cache_dirs(root)
    spec = harness.load_spec(root, args.workload)
    import torch

    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"placebench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(root, args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda", t_start=T_START,
                                  log=lambda line: print(line, file=sys.stderr, flush=True))
    except harness.ForbiddenModules as e:
        print(f"placebench: {e}", file=sys.stderr)
        return 3
    result.pop("numbers")
    io = _io_counters()
    if io:
        print(f"io: {io.get('write_bytes', 0) / 2**20:.1f} MiB dirtied for the disk, "
              f"{io.get('cancelled_write_bytes', 0) / 2**20:.1f} MiB of it deleted unwritten",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
