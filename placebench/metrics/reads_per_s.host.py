"""Reads written to the jplace a second over the measured window's wall time
(first batch handed out to last write), the rate a lab waits for. The shared
host sets it in a cell where the card idles, and its runs swing with the
host's speed, so it is a per-layer metric there."""


def read(run):
    w0, w1 = run.window
    if run.written <= 0 or w1 <= w0:
        return None
    return run.written / (w1 - w0)
