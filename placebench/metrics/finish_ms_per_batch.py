"""Device time of the finish kernels (names beginning ``finish_topk``:
``kernels/csrc/finish_topk.cu``) a batch of the traced window: the finish
that reads back the sums the unfused gather wrote, on the routes that run
it apart."""


def read(run):
    t = run.trace
    if t is None or not run.traced_batches:
        return None
    ms = 1e3 * sum(s for name, s in t["ops"].items() if name.startswith("finish_topk"))
    if ms == 0:
        return None
    return ms / len(run.traced_batches)
