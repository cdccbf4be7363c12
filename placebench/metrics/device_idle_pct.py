"""The share of the traced window in which no kernel, memcpy or memset ran
on the card, from the profiler's timeline."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["n_device_events"] == 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
