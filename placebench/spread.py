"""Two sets of runs of one cell, as a check makes them, and the spread of
each end-to-end metric.

    python3 placebench/spread.py --workload d652.illumina150 --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 20 --out spread_d652.jsonl

Each run is its own process (``run.py``); both sets use the same seeds. For
each metric it prints each set's median and spread (the distance between the
quartiles over the median, ``statistics.quantiles(values, n=4)``), the wider
spread, the spread without each set's run farthest from its median, and five
times the wider spread, the bound it suggests (never under 1%).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def trimmed(values: list[float]) -> list[float]:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    drop = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != drop]


def main(argv=None) -> int:
    import argparse

    from placebench.stats import spread

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    sets: list[list[dict]] = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            t0 = time.monotonic()
            p = subprocess.run([sys.executable, os.path.join(ROOT, "placebench", "run.py"),
                                "--workload", args.workload, "--seed", str(seed),
                                "--seconds", str(args.seconds), "--trace", str(args.trace)],
                               capture_output=True, text=True, cwd=ROOT)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
            rec = {"set": k, "seed": seed, "rc": p.returncode, "wall": time.monotonic() - t0}
            try:
                rec["result"] = json.loads(line)
            except ValueError:
                rec["result"] = None
            if p.returncode != 0 or rec["result"] is None:
                rec["stderr"] = p.stderr[-3000:]
            else:
                rec["log"] = [x for x in p.stderr.splitlines() if not x.startswith("USDT")][-12:]
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            runs.append(rec)
        sets.append(runs)
    names = sorted({m for runs in sets for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for name in names:
        per_set = [[r["result"]["metrics"][name]["value"] for r in runs
                    if r["result"] and name in r["result"]["metrics"]] for runs in sets]
        if not all(len(v) >= 4 for v in per_set):
            continue
        spreads = [spread(v) for v in per_set]
        trims = [spread(trimmed(v)) for v in per_set]
        summary = {"metric": name, "medians": [statistics.median(v) for v in per_set],
                   "spreads": spreads, "widest": max(spreads), "trimmed": trims,
                   "bound_5x": max(0.01, 5 * max(spreads)), "values": per_set}
        print(json.dumps(summary), flush=True)
        if out:
            out.write(json.dumps(summary) + "\n")
    correct = [r["result"]["correct"] for runs in sets for r in runs if r["result"]]
    print(json.dumps({"runs": sum(len(r) for r in sets), "correct": sum(correct),
                      "results": len(correct)}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
