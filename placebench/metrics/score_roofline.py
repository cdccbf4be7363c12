"""The least time the window's placements need, over the card's busy time
in the traced window: bytes over the card's bandwidth or operations over its
float32 rate, whichever is larger, a batch (``placebench/roofline.py``)."""

from concurrent.futures import ThreadPoolExecutor

from placebench import roofline


def read(run):
    t = run.trace
    peaks = roofline.peaks_for(run.device_name)
    if t is None or peaks is None or t["busy_s"] <= 0:
        return None
    buf, off = run.pool
    db = run.db
    table = roofline.key_rows(db["keys"], db["kmer_size"])
    firsts = sorted({(first, n) for _, first, n in run.traced_batches})

    def work(fn):
        first, n = fn
        return fn, roofline.batch_work(buf, off, first, first + n, db["keys"], db["row_off"],
                                       db["kmer_size"], run.K, table)

    with ThreadPoolExecutor(4) as pool:
        per_batch = dict(pool.map(work, firsts))
    least, bound_by = 0.0, {"bytes": 0, "operations": 0}
    for _, first, n in run.traced_batches:
        nbytes, ops = per_batch[(first, n)]
        seconds, by = roofline.least_seconds(nbytes, ops, peaks)
        least += seconds
        bound_by[by] += 1
    run.notes.append(f"score_roofline_pct: least {least:.6f} s over busy {t['busy_s']:.6f} s; "
                     f"batches bound by bytes {bound_by['bytes']}, by operations "
                     f"{bound_by['operations']}")
    return 100.0 * least / t["busy_s"]
