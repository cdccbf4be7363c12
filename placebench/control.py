"""Readings for a cell's limits: the compared numbers of sound runs over many
seeds, and of the control, in one process.

    python3 placebench/control.py --workload d652.illumina150 --seconds 5 \\
        --seeds 11,12,13 [--precision bf16]

The control is the program's own lower-precision path switched on
(``precision="bf16"``: the classic plane in bfloat16), the nearest precision
below the float32 the configurations state. Each seed's numbers print as one
JSON line; the limits in ``cells/<workload>.json`` come from these readings.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    from placebench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--precision", default="exact", choices=["exact", "bf16", "int16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    root = Path(ROOT)
    harness.set_cache_dirs(root)
    overrides = None if args.precision == "exact" else {"precision": args.precision}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        r = harness.run_cell(root, args.workload, seed, args.seconds, False, device=args.device,
                             config_overrides=overrides,
                             log=lambda line: print(line, file=sys.stderr, flush=True))
        line = {"workload": args.workload, "seed": seed, "precision": args.precision,
                "correct": r["correct"], "attempted": r["attempted"],
                "numbers": {k: c["value"] for k, c in r["checks"].items()},
                "numbers_all": r.get("numbers"), "seconds": time.monotonic() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
