"""The share of the measured window that the interpreter spent in garbage
collections, every generation, from the traced run's ``gc.callbacks`` spans
(a collection holds the interpreter lock: the reader, the placer's threads
and the writer all wait). Notes the full (generation 2) collections."""


def read(run):
    spans = run.spans.get("gc")
    w0, w1 = run.window
    if spans is None or w1 <= w0:
        return None
    inside = [(max(a, w0), min(b, w1), g) for a, b, g in spans if b > w0 and a < w1]
    full = [b - a for a, b, g in inside if g == 2]
    run.notes.append(f"gc: {len(inside)} collections in the window, {len(full)} full, "
                     f"{sum(full):.3f} s in full ones")
    return 100.0 * sum(b - a for a, b, _ in inside) / (w1 - w0)
