"""Standalone .ipk layout probe.

Usage: python -m epik_tpu_torch.tools.probe_ipk DB.ipk

Prints the field-by-field layout diagnosis from io/ipk_boost.py::probe_ipk
(reconstructed-layout walk under both size_t widths, failure-site hexdump
with candidate numeric readings, landmark scans).  Also reachable as
``python -m epik_tpu_torch probe DB.ipk``.
"""

from __future__ import annotations

import sys

from ..io.ipk_boost import probe_ipk


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(probe_ipk(sys.argv[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
