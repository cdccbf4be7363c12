"""95th percentile over every batch of the window of its time from the start
of its ``place`` call to the end of its jplace write, from the harness's
spans: what a caller that streams batches waits for one."""

from placebench.stats import percentile


def read(run):
    spans = run.spans.get("batch")
    if not spans:
        return None
    return percentile([1e3 * (b - a) for a, b in spans], 95)
