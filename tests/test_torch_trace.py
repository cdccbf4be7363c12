"""The port's span recorder (``utils/spans.py``) through ``run_pipeline`` and
``TorchPlacer`` on the CPU: off, it records and allocates nothing; on, every
batch has one span of each layer with its batch id, each child inside its
parent on its parent's thread, the placer's counters on its spans, the
collector's runs as ``gc`` spans, the same jplace bytes as with it off, and
the ranges in a ``torch.profiler`` trace and in ``place --verbose``."""

import gc
import itertools
import time
import tracemalloc

import pytest
import torch

from epik_tpu_torch.cli.main import main
from epik_tpu_torch.core.tree import parse_newick, to_newick
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.pipeline import run_pipeline
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.io.build import random_db, random_reads
from epik_tpu_torch.io.db import save
from epik_tpu_torch.io.jplace import jplace_writer
from epik_tpu_torch.utils import spans
from test_pipeline import _ListReader

PER_BATCH = ("pipeline.read", "pipeline.read_wait", "pipeline.result_wait",
             "pipeline.write_put", "place", "place.stage", "place.launch", "place.sync",
             "place.assemble", "pipeline.write")
PLACE_CHILDREN = ("place.stage", "place.launch", "place.sync", "place.assemble")


@pytest.fixture(scope="module")
def small():
    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=81)
    tree = parse_newick(db.tree())
    reads = random_reads(40, length=40, seed=82)
    return db, tree, [reads[i:i + 10] for i in range(0, 40, 10)]


@pytest.fixture
def recorder():
    """The recorder on for one test, off and empty after it."""
    spans.drain()
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.drain()


class _NullWriter:
    def __lshift__(self, placed):
        return self


def _place(placer, tree, batches, path):
    w = jplace_writer(str(path), "inv ", to_newick(tree, jplace_edges=True))
    w.start()
    stats = run_pipeline(placer, _ListReader(batches), w, inflight=2)
    w.end()
    return stats


def test_recorder_off_records_nothing(small, tmp_path):
    db, tree, batches = small
    spans.enable()
    spans.disable()
    spans.drain()
    stats = _place(TorchPlacer(db, tree, device="cpu"), tree, batches, tmp_path / "a.jplace")
    gc.collect()
    assert stats.num_seq_placed == 40 and stats.num_iterations == 4
    assert stats.average_speed == pytest.approx(40 / stats.wall_seconds)
    assert spans.drain() == []
    assert not spans.enabled()
    assert not any(getattr(cb, "__module__", None) == spans.__name__ for cb in gc.callbacks)


def test_off_span_allocates_nothing():
    assert not spans.enabled()
    assert spans.span("place.stage") is spans.span("pipeline.write", 3)

    def loop():
        for _ in itertools.repeat(None, 10_000):
            with spans.span("place.stage"):
                spans.note("route", "csr")
                spans.add("h2d_bytes", 64)

    loop()
    tracemalloc.start()
    try:
        loop()
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop()
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # one allocation a span would be 10,000 of them; the with statement's
    # bound method is freed and reused
    assert current - before < 1024 and peak - before < 1024


def test_each_batch_has_its_spans(small, tmp_path, recorder):
    db, tree, batches = small
    _place(TorchPlacer(db, tree, device="cpu"), tree, batches, tmp_path / "a.jplace")
    recorded = spans.drain()
    for b in range(len(batches)):
        mine = [s for s in recorded if s.batch == b and s.name != "gc"]
        assert sorted(s.name for s in mine) == sorted(PER_BATCH), b
    for s in recorded:
        assert s.start <= s.end and 0 <= s.cpu, s
        if s.name in PLACE_CHILDREN:
            assert s.parent.name == "place"
        if s.parent is not None:
            p = s.parent
            assert p.start <= s.start and s.end <= p.end, (s, p)
            assert s.thread == p.thread and s.batch == p.batch
        elif s.name != "gc":
            assert s.name.startswith("pipeline.") or s.name == "place", s
    # the reader's last call finds no batch; it carries the next id
    assert [s.batch for s in recorded if s.name == "pipeline.read"][-1] == len(batches)
    place = {s.batch: s for s in recorded if s.name == "place"}
    for b, s in place.items():
        assert s.attrs["reads"] == len(batches[b]) and s.attrs["distinct"] == len(batches[b])
        assert s.attrs["route"] == "dense.bytes"
    for s in recorded:
        if s.name == "place.stage":
            assert s.attrs["h2d_bytes"] > 0
    # the reader, the main thread, the writer and at most two workers
    assert len({s.thread for s in recorded}) <= 5


def _thread_clock_step_ns() -> int:
    steps = []
    for _ in range(5):
        t0 = time.thread_time_ns()
        while (t1 := time.thread_time_ns()) == t0:
            pass
        steps.append(t1 - t0)
    return min(steps)


def test_thread_cpu_within_wall(small, tmp_path, recorder):
    """Each span's thread CPU time is no more than its wall time. The CPU
    clock is read inside the wall clock's interval, so this holds span by
    span where the thread clock is fine; where it moves in coarse ticks (10
    ms on some virtual machines), a short span that crosses a tick is
    charged the whole tick and only sums over many spans mean anything."""
    step = _thread_clock_step_ns()
    if step > 100_000:
        pytest.skip(f"the thread CPU clock moves in {step / 1e6:.1f} ms steps here")
    db, tree, batches = small
    _place(TorchPlacer(db, tree, device="cpu"), tree, batches, tmp_path / "a.jplace")
    recorded = spans.drain()
    assert recorded
    for s in recorded:
        assert 0 <= s.cpu <= s.wall, s


def test_jplace_is_the_same_with_the_recorder_on(small, tmp_path):
    db, tree, batches = small
    placer = TorchPlacer(db, tree, device="cpu")
    _place(placer, tree, batches, tmp_path / "off.jplace")
    spans.enable()
    try:
        _place(placer, tree, batches, tmp_path / "on.jplace")
    finally:
        spans.disable()
        spans.drain()
    assert (tmp_path / "on.jplace").read_bytes() == (tmp_path / "off.jplace").read_bytes()


@pytest.mark.parametrize("route,config,iupac", [
    ("dense.bytes", PlacerConfig(), False),
    ("dense.host", PlacerConfig(tokenize_where="host"), False),
    ("tiles", PlacerConfig(dense_db="off"), False),
    ("tiles+csr", PlacerConfig(dense_db="off"), True),
    ("csr", PlacerConfig(accumulate="scatter"), False),
])
def test_route_is_noted_on_place(small, tmp_path, recorder, route, config, iupac):
    db, tree, batches = small
    if iupac:
        batches = [[(name, seq[:5] + b"N" + seq[6:]) if i == 0 else (name, seq)
                    for i, (name, seq) in enumerate(b)] for b in batches]
    _place(TorchPlacer(db, tree, config=config, device="cpu"), tree, batches,
           tmp_path / "a.jplace")
    recorded = spans.drain()
    assert [s.attrs["route"] for s in recorded if s.name == "place"] == [route] * len(batches)
    n_sync = 2 if route == "tiles+csr" else 1
    for b in range(len(batches)):
        names = [s.name for s in recorded if s.batch == b]
        assert names.count("place.stage") == names.count("place.launch") == 1
        assert names.count("place.sync") == n_sync


@pytest.mark.parametrize("config,past_the_rule,gather", [
    (PlacerConfig(), False, "fused"),
    (PlacerConfig(), True, "pair"),
    (PlacerConfig(plane_mode="classic"), False, "fused"),
    (PlacerConfig(plane_mode="classic"), True, "pair"),
    (PlacerConfig(dense_db="off"), False, None),
])
def test_gather_is_noted_on_both_sides_of_the_width_rule(small, tmp_path, recorder, monkeypatch,
                                                         config, past_the_rule, gather):
    """The dense route's ``place`` span notes the gather its step runs: the
    fused kernel, or past the width rule (the shifted plane one step of 128
    columns past ``SHIFTED_TOPK_MAX_BW``; the classic plane past the counts
    kernel's limit) the pair, with the bytes of the (R, bw) sums between
    gather and finish: f32, and int32 counts beside them on the classic
    plane. The tiles route notes neither."""
    from epik_tpu_torch.engine import step
    from epik_tpu_torch.kernels import rowgather

    db, tree, batches = small
    if past_the_rule:  # the small tree's plane is 128 columns wide
        if config.plane_mode == "shifted":
            monkeypatch.setattr(rowgather, "SHIFTED_TOPK_MAX_BW", 0)
        else:
            monkeypatch.setattr(step, "counts_topk_fits", lambda plane, B, K: False)
    placer = TorchPlacer(db, tree, config=config, device="cpu")
    bw = placer.state.plane.shape[1] if placer.route == "dense" else None
    _place(placer, tree, batches, tmp_path / "a.jplace")
    place = [s for s in spans.drain() if s.name == "place"]
    assert len(place) == len(batches)
    for s in place:
        assert s.attrs.get("gather") == gather
        if gather == "pair":
            cell = 4 if placer._shifted else 8
            assert s.attrs["sums_bytes"] == s.attrs["distinct"] * bw * cell
        else:
            assert "sums_bytes" not in s.attrs


def test_budget_retries_are_spans(small, tmp_path, recorder):
    """A CSR budget far below the postings: each batch re-runs, in a
    ``place.retry`` span that notes the budget it ran with."""
    db, tree, batches = small
    placer = TorchPlacer(db, tree, config=PlacerConfig(accumulate="scatter",
                                                       budget_headroom=0.01), device="cpu")
    _place(placer, tree, batches, tmp_path / "a.jplace")
    retries = [s for s in spans.drain() if s.name == "place.retry"]
    assert len(retries) == placer.overflow_retries > 0
    assert all(s.parent.name == "place" and s.attrs["budget"] > 0 for s in retries)


def test_collections_are_gc_spans(recorder):
    with spans.span("outer", 7):
        gc.collect()
    recorded = spans.drain()
    full = [s for s in recorded if s.name == "gc" and s.attrs["generation"] == 2]
    assert full and full[0].parent.name == "outer" and full[0].batch == 7


def test_profiler_shows_the_spans(small, recorder):
    db, tree, batches = small
    placer = TorchPlacer(db, tree, device="cpu")
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=cfg) as prof:
        run_pipeline(placer, _ListReader(batches), _NullWriter(), inflight=2)
    names = {e.name for e in prof.events()}
    assert {"pipeline.read_wait", "pipeline.result_wait", "place", "place.stage",
            "place.launch", "place.sync", "place.assemble"} <= names


def test_cli_verbose_prints_the_spans(small, tmp_path, capsys):
    db, tree, batches = small
    save(db, tmp_path / "DB.eptk")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in itertools.chain(*batches):
            f.write(f">{name}\n{seq.decode()}\n")
    assert main(["place", "-i", str(tmp_path / "DB.eptk"), "-o", str(tmp_path), "--platform",
                 "cpu", "--batch-size", "10", "--verbose", str(tmp_path / "q.fasta")]) == 0
    text = capsys.readouterr().out
    assert "Placed 40 sequences." in text
    rows = {line.split()[0]: line.split() for line in text.splitlines()
            if line.startswith("  ") and line.split()[0] in PER_BATCH}
    assert set(rows) == set(PER_BATCH)
    assert rows["place.stage"][1] == "4" and "routes: dense.bytes 4" in text
    assert "dedup: 40 distinct of 40 reads (100.0%)" in text and "H2D: " in text
    assert not spans.enabled() and spans.drain() == []


@pytest.mark.parametrize("past_the_rule", [False, True])
def test_cli_verbose_prints_the_gathers(small, tmp_path, capsys, monkeypatch, past_the_rule):
    """``place --verbose`` counts the dense steps' gathers and, past the
    width rule, prints the sums the pair wrote and read back a batch."""
    from epik_tpu_torch.kernels import rowgather

    db, tree, batches = small
    if past_the_rule:  # the small tree's plane is 128 columns wide
        monkeypatch.setattr(rowgather, "SHIFTED_TOPK_MAX_BW", 0)
    save(db, tmp_path / "DB.eptk")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in itertools.chain(*batches):
            f.write(f">{name}\n{seq.decode()}\n")
    assert main(["place", "-i", str(tmp_path / "DB.eptk"), "-o", str(tmp_path), "--platform",
                 "cpu", "--batch-size", "10", "--verbose", str(tmp_path / "q.fasta")]) == 0
    text = capsys.readouterr().out
    if past_the_rule:
        mib = f"{10 * 128 * 4 / 2**20:.3f}"
        assert "gathers: pair 4" in text
        assert f"sums written and read back: {mib} MiB a batch, largest {mib}" in text
    else:
        assert "gathers: fused 4" in text and "sums written" not in text


def _made(name, batch, thread, start, end, cpu, parent=None, **attrs):
    """A span as the recorder would close it (times in ms, kept in ns)."""
    s = spans.Span(name, batch)
    s.thread, s.parent, s.attrs = thread, parent, attrs or None
    s.start, s.end, s.cpu = int(start * 1e6), int(end * 1e6), int(cpu * 1e6)
    return s


def _two_batches():
    """Two batches on made spans: reader 1, main 2, worker 3, writer 4."""
    out = []
    for b, t in ((0, 0.0), (1, 10.0)):
        out.append(_made("pipeline.read", b, 1, t, t + 1, 1))
        out.append(_made("pipeline.read_wait", b, 2, t, t + 1.5, 0.1))
        p = _made("place", b, 3, t + 2, t + 12, 4, route="dense.bytes", reads=5, distinct=4)
        out += [_made("place.stage", b, 3, t + 2, t + 4, 1, p, h2d_bytes=64),
                _made("place.launch", b, 3, t + 4, t + 5, 0.5, p),
                _made("place.sync", b, 3, t + 5, t + 10, 0.5, p),
                _made("place.assemble", b, 3, t + 10, t + 11.5, 1.5, p), p]
        out.append(_made("pipeline.write", b, 4, t + 14, t + 16, 2))
    out.append(_made("gc", 1, 3, 10.5, 11.0, 0.5, None, generation=2))
    return out


def test_window_metrics_on_made_spans():
    import span_times

    m = span_times.window_metrics(_two_batches())
    assert m["batches"] == 2 and m["routes"] == {"dense.bytes": 2}
    assert m["stage_ms"] == pytest.approx(2) and m["stage_cpu_ms"] == pytest.approx(1)
    assert m["launch_ms"] == pytest.approx(1) and m["sync_ms"] == pytest.approx(5)
    assert m["assemble_ms"] == pytest.approx(1.5)
    # wall 2 + 1 + 1.5, CPU 1 + 0.5 + 1.5 a batch
    assert m["place_offcpu_pct"] == pytest.approx(100 * 1.5 / 4.5)
    assert m["output_wait_ms"] == pytest.approx(2) and m["input_wait_ms"] == pytest.approx(1.5)
    assert m["place_cover"] == pytest.approx(9.5 / 10)
    assert m["place_uncovered_ms"] == pytest.approx({"head": 0, "between": 0, "tail": 0.5})
    assert m["gc_full"] == 1
    assert m["writer_busy_pct"] == pytest.approx(100 * 4 / 26)
    assert m["pipeline.write_cpu_ms"] == pytest.approx(2)
    # the full collection at 10.5-11 ms falls in batch 1's place call alone
    assert m["batches_under_full_gc"] == 1 and m["batch_p95_no_full_gc_ms"] == pytest.approx(14)
    assert span_times.window_metrics([]) is None


def test_tally_reads_every_counter():
    """The operator's table reads each counter the placer notes: the routes,
    the dedup, the H2D bytes, the retries and their budgets, the
    collections' generations."""
    made = _two_batches()
    p = next(s for s in made if s.name == "place" and s.batch == 1)
    made.append(_made("place.retry", 1, 3, 10, 10.5, 0.1, p, budget=4096, budget_amb=512))
    tally = spans.Tally()
    for s in made:
        tally.add(s)
    lines = tally.table()
    rows = {line.split()[0]: line.split() for line in lines[1:] if ":" not in line}
    assert rows["place.sync"][1:4] == ["2", "5.000", "5.000"]
    assert rows["place.stage"][4] == "50.0%" and rows["gc"][1] == "1"
    assert lines[-5:] == ["routes: dense.bytes 2", "collections, by generation: 2 1",
                          "dedup: 8 distinct of 10 reads (80.0%)",
                          "H2D: 0.1 KiB a batch",
                          "retries: 1, largest budget 4096, ambiguous 512"]


def test_tally_reads_the_gathers():
    """The operator's table counts the dense steps' gathers and gives the
    sums the pair wrote and read back, a batch that ran the pair and the
    largest; a batch whose finish was fused into the posted gather counts
    among the gathers and not there."""
    tally = spans.Tally()
    for b, gather, nbytes in ((0, "fused", None), (1, "pair", 1 << 20), (2, "pair", 2 << 20),
                              (3, "posted_fused", None)):
        attrs = {"route": "dense.bytes", "gather": gather}
        if nbytes:
            attrs["sums_bytes"] = nbytes
        tally.add(_made("place", b, 3, 0, 1, 1, **attrs))
    lines = tally.table()
    assert "routes: dense.bytes 4" in lines
    assert "gathers: fused 1, pair 2, posted_fused 1" in lines
    assert lines[-1] == "sums written and read back: 1.500 MiB a batch, largest 2.000"


def test_tally_memory_is_bounded():
    """Past ``SAMPLE`` spans of a name the tally keeps a sample of that size;
    below it the 95th percentile is exact."""
    tally = spans.Tally()
    tally.SAMPLE = 50
    for i in range(40):
        tally.add(_made("place", i, 1, 0, i + 1, 0))
    assert tally.table()[1].split()[3] == "38.000"
    for i in range(40, 1000):
        tally.add(_made("place", i, 1, 0, i + 1, 0))
    count, wall, _, sample = tally.names["place"]
    assert count == 1000 and wall == sum(range(1, 1001)) * 10**6 and len(sample) == 50


def test_gap_labels_on_a_made_trace():
    """The trace's clock marker at 1,000 us is monotonic 5 s; kernels busy
    the card but for [2 ms, 9 ms] of the window: the gap's middle (5.5 ms)
    falls in batch 0's ``place.sync``, its read's wait and no write."""
    import span_times

    events = [{"name": "placebench.clock", "ts": 1000.0, "ph": "X", "dur": 1.0},
              {"name": "k", "cat": "kernel", "ph": "X", "ts": 1000.0, "dur": 2000.0},
              {"name": "k", "cat": "kernel", "ph": "X", "ts": 10000.0, "dur": 16000.0}]
    recorded = [s for s in _two_batches() if s.batch == 0]
    for s in recorded:  # spans on the monotonic clock from 5 s
        s.start += 5_000_000_000
        s.end += 5_000_000_000
    gaps = span_times.gap_labels(events, 5.0, (5.0, 5.025), recorded, top=3)
    assert [round(g["s"], 6) for g in gaps] == [0.007]
    assert gaps[0]["at"] == {"main": ["-"], "reader": ["-"], "worker": ["place.sync"],
                             "writer": ["-"]}


def test_span_times_on_a_tiny_cell(tmp_path):
    """The tool's whole run on the CPU, on a tiny cell of the benchmark, in
    a process of its own (the harness refuses to run beside JAX)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from placebench.tests.test_placebench_harness import make_root

    repo = Path(__file__).resolve().parents[1]
    root = make_root(tmp_path)
    run = subprocess.run(
        [sys.executable, str(repo / "span_times.py"), "--device", "cpu", "--root", str(root),
         "--workload", "tiny.short", "--seed", str(2**33 + 5), "--seconds", "0.3"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["recorder"] is True
    for window in ("measured", "traced"):
        m = line[window]
        assert m["batches"] > 0 and m["routes"] == {"dense.bytes": m["batches"]}
        assert 0 <= m["place_offcpu_pct"] <= 100 and 0.9 < m["place_cover"] <= 1
