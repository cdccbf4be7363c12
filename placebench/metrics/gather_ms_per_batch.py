"""Device time of the row-gather kernels (names beginning ``rowgather``:
``kernels/csrc/rowgather_sum.cu``) a batch of the traced window."""


def read(run):
    t = run.trace
    if t is None or not run.traced_batches:
        return None
    ms = 1e3 * sum(s for name, s in t["ops"].items() if name.startswith("rowgather"))
    if ms == 0:
        return None
    return ms / len(run.traced_batches)
