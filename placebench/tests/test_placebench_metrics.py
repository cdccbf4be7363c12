"""The metric arithmetic: the tail, the spread, the trace's idle share and
kernel time, the roofline's bytes and operations, and the no-JAX check."""

import statistics

import numpy as np
import pytest

from placebench import harness, roofline, trace
from placebench.stats import percentile, spread

FOLDER = harness.Path(harness.__file__).resolve().parent


def test_p95_over_all_batches():
    values = [float(v) for v in range(1, 101)]
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile(values, 95) == pytest.approx(float(np.percentile(values, 95)))
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile([7.0], 95) == 7.0
    # one slow batch in twenty sets it
    assert percentile([10.0] * 19 + [100.0], 95) == pytest.approx(14.5)
    # the reader takes it over every batch's span, place call to write end
    spans = [(float(i), float(i) + 0.010) for i in range(19)] + [(19.0, 19.1)]
    run = harness.Run(window=(0.0, 20.0), spans={"batch": spans}, stats=None, batches=[],
                      trace=None, traced_batches=[], device_name="cpu", pool=None, db=None,
                      K=7, notes=[])
    assert harness.read_metric(FOLDER, "batch_p95_ms", run) == pytest.approx(14.5)
    assert harness.read_metric(FOLDER, "batch_p95_ms", harness.Run(
        window=(0.0, 0.0), spans={"batch": []}, stats=None, batches=[], trace=None,
        traced_batches=[], device_name="cpu", pool=None, db=None, K=7, notes=[])) is None


def test_gc_pause_share_of_the_window():
    import gc

    def run_with(spans):
        return harness.Run(window=(10.0, 20.0), spans=spans, stats=None, batches=[],
                           trace=None, traced_batches=[], device_name="cpu", pool=None,
                           db=None, K=7, notes=[])

    # clipped to the window: 0.5 s inside of the first, 1 s, 0.2 s of the last
    run = run_with({"gc": [(9.5, 10.5, 2), (12.0, 13.0, 0), (19.8, 20.4, 2), (21.0, 22.0, 2)]})
    assert harness.read_metric(FOLDER, "gc_pause_pct", run) == pytest.approx(17.0)
    assert run.notes == ["gc: 3 collections in the window, 2 full, 0.700 s in full ones"]
    # an untraced run records no collections
    assert harness.read_metric(FOLDER, "gc_pause_pct", run_with({})) is None
    # the recorder sees a collection of each generation it is asked for
    with harness.GcPauses() as pauses:
        gc.collect(0)
        gc.collect(2)
    assert [g for _, _, g in pauses.spans] == [0, 2]
    assert all(b >= a for a, b, _ in pauses.spans)
    assert pauses not in gc.callbacks


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert spread(values) == pytest.approx((q3 - q1) / med)


def synthetic_trace(mark_ts=1_000_000.0):
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.CLOCK_MARK, "ts": mark_ts, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "void rowgather_slices_kernel<float>(float const*)",
         "ts": mark_ts + 1000, "dur": 2000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": mark_ts + 2500, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "void finish_topk_kernel<7>(float*)",
         "ts": mark_ts + 6000, "dur": 1000},
        # outside the window: clipped away
        {"ph": "X", "cat": "kernel", "name": "late", "ts": mark_ts + 20000, "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": mark_ts + 100, "dur": 9000},
    ]


def run_with(summary, batches=2):
    return harness.Run(window=(0.0, 0.01), spans={"read": [], "place": [], "write": []},
                       stats=None, batches=[], trace=summary,
                       traced_batches=[(0, 0, 1)] * batches,
                       device_name="NVIDIA H100 80GB HBM3", pool=None, db=None, K=7, notes=[])


def test_idle_share_and_gather_time_from_a_trace():
    mono = 50.0  # the marker opened at monotonic 50 s
    spans = {"read": [(mono, mono + 0.0055)], "place": [(mono + 0.004, mono + 0.009)]}
    t = trace.reduce_trace(synthetic_trace(), mono, (mono, mono + 0.010), spans)
    # busy: [1, 3.5] ms and [6, 7] ms of a 10 ms window
    assert t["busy_s"] == pytest.approx(0.0035)
    assert t["window_s"] == pytest.approx(0.010)
    assert t["ops"]["rowgather_slices_kernel<float>"] == pytest.approx(0.002)
    assert "late" not in t["ops"] and "aten::add" not in t["ops"]
    assert t["gaps"] == [("place", pytest.approx(0.003)), ("place+read", pytest.approx(0.0025)),
                         ("read", pytest.approx(0.001))]
    run = run_with(t, batches=2)
    assert harness.read_metric(FOLDER, "device_idle_pct", run) == pytest.approx(65.0)
    assert harness.read_metric(FOLDER, "gather_ms_per_batch", run) == pytest.approx(1.0)
    assert harness.read_metric(FOLDER, "device_idle_pct", run_with(None)) is None
    assert trace.reduce_trace(synthetic_trace()[1:], mono, (mono, mono + 1), spans) is None


def test_card_busy_time_over_a_whole_trace():
    # the window's own profile: every device event counts, overlaps once, host events never
    busy, n = trace.busy_seconds(synthetic_trace())
    assert n == 4
    assert busy == pytest.approx((2500 + 1000 + 500) * 1e-6)
    assert trace.busy_seconds([e for e in synthetic_trace() if e["cat"] == "cpu_op"]) == (0.0, 0)


def test_host_rate_over_the_window():
    def run(written, window):
        return harness.Run(window=window, spans={}, stats=None, batches=[], trace=None,
                           traced_batches=[], device_name="cpu", pool=None, db=None, K=7,
                           notes=[], written=written)

    assert harness.read_metric(FOLDER, "reads_per_s.host", run(4000, (1.0, 3.0))) == 2000.0
    assert harness.read_metric(FOLDER, "reads_per_s.host", run(0, (1.0, 3.0))) is None


def test_roofline_work_by_hand():
    keys = np.array([1, 6], np.uint64)  # "AC" (2 postings), "CG" (1 posting)
    row_off = np.array([0, 2, 3])
    buf = np.frombuffer(b"ACGAC", np.uint8)  # reads "AC" and "GAC"; "CG" straddles them
    off = np.array([0, 2, 5])
    table = roofline.key_rows(keys, 2)
    for tab in (table, None):
        nbytes, ops = roofline.batch_work(buf, off, 0, 2, keys, row_off, 2, 7, tab)
        assert ops == 2 + 2  # AC in each read
        assert nbytes == 8 * 2 + 5 + 8 * 7 * 2  # AC's postings, 5 bases, 7 rows a read
    amb = np.frombuffer(b"ANCG", np.uint8)
    assert roofline.batch_work(amb, np.array([0, 4]), 0, 1, keys, row_off, 2, 1, table) == (
        8 * 1 + 4 + 8, 1)
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert roofline.least_seconds(3.35e12, 1.0, peaks) == (pytest.approx(1.0), "bytes")
    assert roofline.least_seconds(1.0, 134e12, peaks) == (pytest.approx(2.0), "operations")
    assert roofline.peaks_for("cpu") is None


@pytest.mark.parametrize("names,found", [
    ({"epik_tpu_torch", "epik_tpu_torch.x", "numpy"}, []),
    ({"epik_tpu.x", "numpy"}, ["epik_tpu.x"]),
    ({"jax.numpy"}, ["jax.numpy"]),
    ({"jaxlib", "flax.linen", "jaxtyping"}, ["flax.linen", "jaxlib"]),
    ({"epik_tpu"}, ["epik_tpu"]),
])
def test_no_jax_check(names, found):
    assert harness.forbidden_modules(names) == found
