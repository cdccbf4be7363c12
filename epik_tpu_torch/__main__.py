"""``python -m epik_tpu_torch <command> ...``: place, diff, probe, convert, stats,
build-db, ppdiff."""

from .cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
