"""Mean time of a ``TorchPlacer.place`` call (staging, dispatch, the device
step, the transfer back, assembly), from the harness's spans."""


def read(run):
    spans = run.spans["place"]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
