"""The gather over a shifted f32 plane's posted cells on the CPU
(``engine/state.py::build_posted`` / ``posted_index``,
``kernels/rowgather.py::rowgather_sum_posted``), alone and with the finish
fused in (``rowgather_sum_posted_topk``).

Past the width rule the shifted dense steps gather a read's sums apart from
the finish. Where at most 1/32 of the plane's cells are posted, the placer
keeps a row-compressed copy of them, read back from the finished plane, and
the gather adds those cells alone: bit for bit the sums of 1d over the
plane's rows, since a shifted cell is above zero where posted and exactly 0
elsewhere. Where its shared memory fits (``posted_topk_fits``), the finish
runs in the same kernel, from the sums in shared memory; past it, the posted
gather and ``finish_topk`` apart (the pair). Here: the index against the
plane it was read from, the plain versions against 1d's and the pair's, the
placer's rule and the route rule, the router's and the placer's pack through
each gather, and the span note the dense route makes.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from epik_tpu.core.tree import parse_newick as jax_parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.io.build import reference_like_db as jax_reference_like_db

from epik_tpu_torch.cli.main import main
from epik_tpu_torch.core.scoring import score_threshold
from epik_tpu_torch.core.tree import parse_newick
from epik_tpu_torch.engine import state as state_mod
from epik_tpu_torch.engine import step as step_mod
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.state import build_plane_state, build_posted, pair_tables
from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
from epik_tpu_torch.io.db import save
from epik_tpu_torch.kernels import rowgather as rg
from epik_tpu_torch.kernels._build import _PROTOTYPES, _RESTYPES, CSRC
from epik_tpu_torch.kernels.finish import finish_topk_plain
from epik_tpu_torch.ops.dense import amb_deltas
from epik_tpu_torch.utils import spans
from test_torch_placer import assert_jplace_close

#: a tree of 100 leaves (199 branches, a plane 256 columns wide) and ~2.5
#: postings a key: ~1% of the plane's cells posted, ~2% of the pair plane's
DB_ARGS = dict(num_leaves=100, kmer_size=6, ref_length=6_000, mean_posting_len=2.5, seed=231)


@pytest.fixture(scope="module")
def fx():
    db, ref = reference_like_db(**DB_ARGS)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 40, length=80, mutation_rate=0.03, seed=232)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]), ("short", b"ACG"),
              ("nohit", b"T" * 30)]
    return db, tree, reads


@pytest.fixture
def past_the_rule(monkeypatch):
    """The width rule set below the fixture's 256 columns: the shifted steps
    gather apart from #1."""
    monkeypatch.setattr(rg, "SHIFTED_TOPK_MAX_BW", 128)


#: the posted routes: the finish fused into the posted gather (where it fits),
#: and the posted gather and ``finish_topk`` apart (past its limit)
ROUTES = ["posted_fused", "posted"]


def _take(monkeypatch, route: str) -> None:
    """Past the fused posted gather's limit for the route ``posted``: its
    rule refuses every shape, as past the card's shared memory."""
    if route == "posted":
        monkeypatch.setattr(step_mod, "posted_topk_fits", lambda bw, B, device: False)


def _log_eps(db) -> np.float32:
    return np.float32(np.log10(np.float32(score_threshold(db.omega, db.kmer_size, 4))))


def _cells_of(plane: torch.Tensor, r: int):
    cols = torch.nonzero(plane[r]).flatten()
    return cols.to(torch.int32), plane[r, cols].view(torch.int32)


@pytest.mark.parametrize("paired", [False, True])
def test_index_holds_the_planes_non_zero_cells(fx, monkeypatch, paired):
    """Every row's range holds its non-zero cells, in column order, with the
    value's bits: the unpaired rows, the pair rows (each the f32 sum of two
    base rows), the zero row's empty range and a score at the threshold,
    nudged to 1e-37; read a few rows a chunk, so the chunks' seams run too."""
    db = fx[0]
    log_eps = _log_eps(db)
    db = dataclasses.replace(db, scores=db.scores.copy())
    db.scores[5] = log_eps  # shifted to 0, nudged to 1e-37
    pairs = pair_tables(db, db.kmer_size) if paired else None
    st = build_plane_state(db, k=db.kmer_size, B=199, log_eps=log_eps, shifted=True,
                           precision="exact", pairs=pairs, device="cpu")
    plane = st.plane
    monkeypatch.setattr(state_mod, "_POSTED_CHUNK_CELLS", 7 * plane.shape[1] + 3)
    p = build_posted(plane)
    assert p.off.dtype == torch.int64 and p.off.shape == (plane.shape[0] + 1,)
    assert p.cells.dtype == torch.int32 and p.cells.shape == (int(p.off[-1]), 2)
    assert p.nnz == int(torch.count_nonzero(plane)) > 0
    assert p.nbytes == p.off.numel() * 8 + p.nnz * 8
    assert st.n_pairs > 0 if paired else st.n_pairs == 0
    off = p.off.tolist()
    for r in range(plane.shape[0]):
        cols, bits = _cells_of(plane, r)
        assert torch.equal(p.cells[off[r]:off[r + 1], 0], cols), r
        assert torch.equal(p.cells[off[r]:off[r + 1], 1], bits), r
    assert off[st.n_keys] == off[st.n_keys + 1]  # the zero row
    row = int(np.searchsorted(db.row_off, 5, side="right") - 1)
    col = int(db.branches[5])
    got = p.cells[off[row]:off[row + 1]]
    at = (got[:, 0] == col).nonzero().flatten()
    assert at.numel() == 1
    assert got[at[0], 1].view(torch.float32) == np.float32(1e-37)
    # the dense plane again from the index, bit for bit
    back = torch.zeros_like(plane)
    rows = torch.repeat_interleave(torch.arange(plane.shape[0]), p.off.diff())
    back[rows, p.cells[:, 0].long()] = p.cells[:, 1].contiguous().view(torch.float32)
    assert torch.equal(back.view(torch.int32), plane.view(torch.int32))


def _sparse_plane(rng, n_rows: int, bw: int, per_row: int = 12) -> torch.Tensor:
    """A shifted plane: ~per_row posted cells a row over a wide range of
    magnitudes (so an add out of order changes bits), some at 1e-37, the
    last row all zero."""
    plane = np.zeros((n_rows, bw), np.float32)
    for r in range(n_rows - 1):
        cols = rng.choice(bw, rng.integers(0, 2 * per_row), replace=False)
        plane[r, cols] = (10.0 ** rng.uniform(-6, 1.5, cols.size)).astype(np.float32)
        plane[r, cols[: cols.size // 10]] = np.float32(1e-37)
    return torch.from_numpy(plane)


@pytest.mark.parametrize("case", ["wide", "misses", "repeats", "short", "empty"])
def test_posted_plain_is_bit_equal_to_1d_plain(case):
    """``rowgather_sum_posted_plain`` (and the wrapper on the CPU) against
    ``rowgather_sum_plain`` over the plane the index was read from, bit for
    bit, at a width past the width rule: random rows; a third of the windows
    misses (the zero row); a read naming one row in several windows; reads
    shorter than k (every window the zero row); no read at all."""
    rng = np.random.default_rng(["wide", "misses", "repeats", "short", "empty"].index(case))
    bw, n_rows, W = 1792, 300, 41
    zero = n_rows - 1
    plane = _sparse_plane(rng, n_rows, bw)
    R = 0 if case == "empty" else 24
    rows = rng.integers(0, n_rows - 1, (R, W)).astype(np.int32)
    if case == "misses":
        rows[rng.random(rows.shape) < 0.3] = zero
    elif case == "repeats":
        rows[:, 7] = rows[:, 3]
        rows[:, 20:30] = rows[:, [0]]
    elif case == "short":
        rows[::3] = zero
    rows = torch.from_numpy(rows)
    p = build_posted(plane)
    want = rg.rowgather_sum_plain(plane, rows)
    for got in (rg.rowgather_sum_posted_plain(p.off, p.cells, rows, bw),
                rg.rowgather_sum_posted(p.off, p.cells, rows, bw=bw)):
        assert got.shape == (R, bw) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "short":
        assert not rg.rowgather_sum_posted(p.off, p.cells, rows, bw=bw)[::3].any()


def test_posted_wrapper_checks_its_arguments():
    plane = _sparse_plane(np.random.default_rng(3), 20, 256)
    p = build_posted(plane)
    rows = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        rg.rowgather_sum_posted(p.off, p.cells, rows.long(), bw=256)
    with pytest.raises(ValueError, match="off"):
        rg.rowgather_sum_posted(p.off.int(), p.cells, rows, bw=256)
    with pytest.raises(ValueError, match="cells"):
        rg.rowgather_sum_posted(p.off, p.cells.flatten(), rows, bw=256)
    with pytest.raises(ValueError, match="bw"):
        rg.rowgather_sum_posted(p.off, p.cells, rows, bw=254)
    with pytest.raises(ValueError, match="f32 plane"):
        build_posted(plane.to(torch.int16))


def _posted_topk_case(case: str):
    """(plane, its posted cells, rows, m, amb_read, amb_delta, B, K) for the
    fused posted gather's plain version: a plane past the width rule, its
    last 92 columns padding past B; ``amb``: a quarter of the reads with a
    delta row, some of it negative and some branches touched by it alone;
    ``short``: every third read's windows all on the zero row (n = 0, the
    slots past n at the lowest ids); ``few``: one window a read, on a row of
    fewer than K cells for every other read (n < K); ``empty``: no read."""
    rng = np.random.default_rng(["plain", "amb", "short", "few", "empty"].index(case) + 40)
    bw, B, n_rows, W, K = 1792, 1700, 300, 41, 7
    zero = n_rows - 1
    plane = _sparse_plane(rng, n_rows, bw)
    plane[:, B:] = 0.0
    R = 0 if case == "empty" else 24
    if case == "few":
        W = 1
    rows = rng.integers(0, n_rows - 1, (R, W)).astype(np.int32)
    if case == "short":
        rows[::3] = zero
    elif case == "few":
        sparse = np.flatnonzero((plane[:-1] != 0).sum(1).numpy() < K)
        rows[::2, 0] = rng.choice(sparse, rows[::2].shape[0])
    m = torch.from_numpy(rng.integers(W, W + 40, R).astype(np.float32))
    amb_read = amb_delta = None
    if case == "amb":
        amb_read = torch.arange(1, R, 4)
        amb_delta = torch.from_numpy(
            rng.uniform(-0.5, 2.0, (amb_read.numel(), B)).astype(np.float32))
        amb_delta[amb_delta < 1.0] = 0.0
    return plane, build_posted(plane), torch.from_numpy(rows), m, amb_read, amb_delta, B, K


@pytest.mark.parametrize("case", ["plain", "amb", "short", "few", "empty"])
def test_posted_topk_plain_is_the_pair(case):
    """``rowgather_sum_posted_topk_plain`` (and the wrapper on the CPU) against
    the pair it stands for, 1d's plain sums over the plane (its posted cells'
    sums, bit for bit), the delta rows added and ``finish_topk``'s plain
    version: the same pack, bit for bit."""
    plane, p, rows, m, amb_read, amb_delta, B, K = _posted_topk_case(case)
    bw = plane.shape[1]
    kw = dict(B=B, K=K, k=6, log_eps=-4.2597)
    Sp = rg.rowgather_sum_plain(plane, rows)[:, :B]
    if amb_read is not None:
        Sp[amb_read] = Sp[amb_read] + amb_delta
    want = finish_topk_plain(Sp, m, K=K, k=6, log_eps=-4.2597)
    for got in (rg.rowgather_sum_posted_topk_plain(p.off, p.cells, rows, m, amb_read, amb_delta,
                                                   bw=bw, **kw),
                rg.rowgather_sum_posted_topk(p.off, p.cells, rows, m, amb_read, amb_delta,
                                             bw=bw, **kw)):
        assert got.shape == (rows.shape[0], 2 * K + 3) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    n = want[:, 2 * K + 1]
    if case == "short":
        assert (n[::3] == 0).all() and (want[::3, K:2 * K] == torch.arange(K)).all()
    if case == "few":
        assert (n[::2] < K).all()


def test_posted_topk_wrapper_checks_its_arguments():
    plane = _sparse_plane(np.random.default_rng(4), 20, 256)
    p = build_posted(plane)
    rows = torch.zeros((2, 3), dtype=torch.int32)
    m = torch.ones(2)
    kw = dict(bw=256, B=200, K=7, k=6, log_eps=-4.0)

    def call(**over):
        args = dict(off=p.off, cells=p.cells, rows=rows, m_f32=m, amb_read=None,
                    amb_delta=None, **kw)
        args.update(over)
        return rg.rowgather_sum_posted_topk(**args)

    assert call().shape == (2, 17)
    with pytest.raises(ValueError, match="rows"):
        call(rows=rows.long())
    with pytest.raises(ValueError, match="off"):
        call(off=p.off.int())
    with pytest.raises(ValueError, match="bw"):
        call(bw=254)
    with pytest.raises(ValueError, match="m_f32"):
        call(m_f32=torch.ones(3))
    with pytest.raises(ValueError, match="B=300"):
        call(B=300)
    with pytest.raises(ValueError, match="K=65"):
        call(K=65)
    with pytest.raises(ValueError, match="come together"):
        call(amb_read=torch.tensor([1]))
    with pytest.raises(ValueError, match="amb_delta"):
        call(amb_read=torch.tensor([1]), amb_delta=torch.zeros((1, 199)))


@pytest.mark.parametrize("bw,B,fits", [
    (21_248, 21_149, True),  # the wol10k cell's
    (20_096, 19_999, True),  # config 4's
    (40_064, 39_999, True),  # the wide shifted tree's
    (51_456, 51_400, False),  # past the shared memory by the touched bits
    (52_992, 1_000, False),  # past the shared memory by the sums
    (65_540, 1_000, False),  # past the 16-bit column ids
])
def test_posted_topk_fits_holds_the_shared_memory(monkeypatch, bw, B, fits):
    """``posted_topk_fits`` on a card: the fused kernel's bytes (the CUDA
    source's formula, here with the sums, the touched bits in whole pairs of
    words and the staging as ``rowgather_posted.cu`` lays them) within the
    bytes a block may take (an H100's opt-in 232,448 less the kernel's static
    9,280), and 16-bit column ids; the CPU has no limit."""
    staging = 1024 * 8 + 256 * 8 + 257 * 4

    def smem(bw, B, device):
        return 4 * bw + 4 * 2 * -(-B // 64) + staging, 232_448 - 9_280

    monkeypatch.setattr(rg, "posted_topk_smem", smem)
    assert rg.posted_topk_fits(bw, B, "cuda") == fits
    assert rg.posted_topk_fits(bw, B, "cpu")


@pytest.mark.parametrize("bw,route", [
    (256, "fused"),  # within the width rule: #1
    (1_792, "posted_fused"),  # past it, within the fused posted gather's limit
    (2_048, "posted"),  # past that limit: the posted gather and finish_topk apart
])
def test_dense_gather_fuses_the_posted_finish_below_its_limit(monkeypatch, bw, route):
    """``dense_gather`` with the posted cells given: #1 within the width rule;
    past it the finish fused into the posted gather where
    ``posted_topk_fits`` takes (bw, B, K), else the pair; without the posted
    cells ``rows`` (1d). The limit here: 1,800 columns."""
    monkeypatch.setattr(step_mod, "posted_topk_fits", lambda bw, B, device: bw <= 1_800)
    plane = _sparse_plane(np.random.default_rng(bw), 30, bw)
    posted = build_posted(plane)
    gather = step_mod.dense_gather(plane, bw - 64, 7, shifted=True, posted=posted)
    if route == "fused":
        assert gather == "fused"
        return
    assert isinstance(gather, step_mod.PostedGather) and gather.cells is posted
    assert gather.note == route and gather.fused == (route == "posted_fused")
    assert step_mod.dense_gather(plane, bw - 64, 7, shifted=True) == "rows"


_C_KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_int64}


@pytest.mark.parametrize("name", ["epik_rowgather_sum_posted", "epik_rowgather_sum_posted_topk",
                                  "epik_rowgather_posted_smem",
                                  "epik_rowgather_posted_topk_smem",
                                  "epik_rowgather_posted_smem_limit",
                                  "epik_rowgather_posted_topk_smem_limit",
                                  "epik_rowgather_posted_blocks_per_sm",
                                  "epik_rowgather_posted_topk_blocks_per_sm"])
def test_posted_prototypes_match_the_c_source(name):
    """``_PROTOTYPES`` gives each of ``rowgather_posted.cu``'s entry points one
    argument type per parameter of its C definition, and ``_RESTYPES`` its
    64-bit results."""
    src = (CSRC / "rowgather_posted.cu").read_text()
    ret, params = re.search(rf'extern "C" (int|long long) {name}\(([^)]*)\)', src).groups()
    kinds = [ctypes.c_void_p if "*" in q else _C_KINDS[q.strip().rsplit(" ", 1)[0]]
             for q in params.split(",") if q.strip()]
    assert _PROTOTYPES[name] == kinds
    assert _RESTYPES.get(name, ctypes.c_int) == (ctypes.c_longlong if ret == "long long"
                                                 else ctypes.c_int)


@pytest.mark.parametrize("case,fields,rule,built", [
    ("past", {"pair_plane": "off"}, True, True),
    ("past_pair", {}, True, True),
    ("within", {"pair_plane": "off"}, False, False),
    ("int16", {"precision": "int16"}, True, False),
    ("classic", {"plane_mode": "classic"}, True, False),
    ("denser", {"pair_plane": "off"}, True, False),
    ("over_budget", {"pair_plane": "off"}, True, False),
    ("at_budget", {"pair_plane": "off"}, True, True),
])
def test_placer_builds_the_index_where_the_rule_says(fx, monkeypatch, case, fields, rule,
                                                     built):
    """The placer holds the posted cells where the shifted f32 steps gather
    apart (past the width rule), the plane is sparse (at most 1/32 of its
    cells posted) and the index fits the budget beside the plane; not
    within the width rule, on the int16 or the classic plane, on a denser
    plane, or one byte over the budget. The state's bytes count it."""
    db, tree, _ = fx
    if case == "denser":  # ~12 postings a key over 256 columns: ~4.7% posted
        db, _ = reference_like_db(**dict(DB_ARGS, mean_posting_len=12.0))
        tree = parse_newick(db.tree())
    if rule:
        monkeypatch.setattr(rg, "SHIFTED_TOPK_MAX_BW", 128)
    if case.endswith("budget"):
        whole = TorchPlacer(db, tree, config=PlacerConfig(**fields), device="cpu").state.nbytes
        fields = dict(fields, dense_db_budget=whole - (case == "over_budget"))
    placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device="cpu")
    st = placer.state
    assert placer.route == "dense" and st.plane.shape[1] == 256
    assert placer._paired == (case == "past_pair")
    assert (st.posted is not None) == built
    if built:
        assert st.posted.nnz == int(torch.count_nonzero(st.plane))
        assert st.posted.nnz <= st.plane.numel() / 32
        assert st.nbytes == dataclasses.replace(st, posted=None).nbytes + st.posted.nbytes
        assert "posted cells" in placer.posted_line()
    else:
        assert placer.posted_line() == ""
        if case == "denser":
            assert int(torch.count_nonzero(st.plane)) > st.plane.numel() / 32


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("amb,pair_rows", [(False, False), (True, False), (True, True)])
def test_router_gives_the_same_pack_through_both_gathers(monkeypatch, amb, pair_rows, route):
    """``engine.step._shifted_finish`` past the width rule, with and without
    the posted cells: the same pack, bit for bit (the delta rows of the
    ambiguous reads added to the same sums); with them, the posted gather
    with the finish fused in (``posted_fused``) or, past its limit, the
    posted gather in place of 1d and ``finish_topk`` after it
    (``posted``)."""
    rng = np.random.default_rng(7 + amb + 2 * pair_rows)
    bw, B, R, W, n_rows = 1792, 1700, 30, 40, 200
    plane = _sparse_plane(rng, n_rows, bw)
    plane[:, B:] = 0.0
    rows = torch.from_numpy(rng.integers(0, n_rows, (R, W)).astype(np.int32))
    m = torch.from_numpy(rng.integers(W, W + 40, R).astype(np.float32))
    arows = torch.full((R, 2), n_rows - 1, dtype=torch.int32)
    if amb:
        arows[1::4, 0] = torch.from_numpy(rng.integers(0, n_rows - 1, arows[1::4].shape[0]))
    seen = {}
    for name in ("rowgather_sum", "rowgather_sum_posted", "rowgather_sum_posted_topk",
                 "finish_topk"):
        fn = getattr(step_mod, name)

        def counted(*a, _fn=fn, _n=name, **k):
            seen[_n] = seen.get(_n, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(step_mod, name, counted)
    kw = dict(B=B, K=7, Amax=2 if amb else 0, k=6, zero_row=n_rows - 1, log_eps=-4.2597,
              eps=5.5e-5, pair_rows=pair_rows)
    gather = step_mod.dense_gather(plane, B, 7, shifted=True)
    assert gather == "rows"
    apart = step_mod._shifted_finish(plane, rows, m, arows, gather=gather, **kw)
    assert seen == {"rowgather_sum": 1, "finish_topk": 1}
    _take(monkeypatch, route)
    gather = step_mod.dense_gather(plane, B, 7, shifted=True, posted=build_posted(plane))
    assert isinstance(gather, step_mod.PostedGather) and gather.note == route
    posted = step_mod._shifted_finish(plane, rows, m, arows, gather=gather, **kw)
    if route == "posted":
        assert seen == {"rowgather_sum": 1, "rowgather_sum_posted": 1, "finish_topk": 2}
    else:
        assert seen == {"rowgather_sum": 1, "rowgather_sum_posted_topk": 1, "finish_topk": 1}
    assert torch.equal(posted.view(torch.int32), apart.view(torch.int32))
    if amb:
        reads, _ = amb_deltas(plane, arows, zero_row=n_rows - 1, B=B, k=6, eps=5.5e-5,
                              log_eps=-4.2597)
        assert reads.numel() > 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fields", [{"pair_plane": "off"}, {}])
def test_placer_places_the_same_through_both_gathers(fx, past_the_rule, monkeypatch, fields,
                                                     route):
    """The placer past the width rule with its posted cells (the finish fused
    in, or past its limit apart), and again with them taken away (1d): the
    same placements, bit for bit; and both within 1e-4 of the JAX package's
    placer."""
    db, tree, reads = fx
    _take(monkeypatch, route)
    placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device="cpu")
    assert placer.state.posted is not None
    assert placer._gather.cells is placer.state.posted and placer._gather.note == route
    got = placer.place(reads)
    placer.state = dataclasses.replace(placer.state, posted=None)
    placer._gather = "rows"
    want = placer.place(reads)
    for a, b in zip(got.placed_seqs, want.placed_seqs, strict=True):
        assert a.sequence == b.sequence and a.placements == b.placements
    jdb, _ = jax_reference_like_db(**DB_ARGS)
    jax = JaxPlacer(jdb, jax_parse_newick(jdb.tree()))
    assert_jplace_close(jax.place(reads), got)


@pytest.fixture
def recorder():
    spans.drain()
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.drain()


@pytest.mark.parametrize("route", ROUTES)
def test_span_notes_the_posted_gather(fx, past_the_rule, recorder, monkeypatch, route):
    """With the recorder on, each ``place`` span of the dense route past the
    width rule notes ``gather`` = ``posted_fused`` and no sums (the finish
    reads them in shared memory) or, past the fused kernel's limit,
    ``posted`` and the (R, bw) f32 sums the gather writes and ``finish_topk``
    reads back; the tally counts them."""
    db, tree, reads = fx
    _take(monkeypatch, route)
    placer = TorchPlacer(db, tree, config=PlacerConfig(pair_plane="off"), device="cpu")
    batches = [reads[i:i + 11] for i in range(0, len(reads), 11)]
    for batch in batches:
        with spans.span("place"):
            placer.place(batch)
    tally = spans.Tally()
    place = [s for s in spans.drain() if s.name == "place"]
    assert len(place) == len(batches)
    for s in place:
        assert s.attrs["gather"] == route
        if route == "posted":
            assert s.attrs["sums_bytes"] == s.attrs["distinct"] * 256 * 4
        else:
            assert "sums_bytes" not in s.attrs
        tally.add(s)
    lines = tally.table()
    assert f"gathers: {route} {len(batches)}" in lines
    assert any(line.startswith("sums written and read back: ") for line in lines) == (
        route == "posted")


@pytest.mark.parametrize("route", ROUTES)
def test_cli_verbose_prints_the_posted_gathers(fx, tmp_path, capsys, past_the_rule, monkeypatch,
                                               route):
    """``place --verbose``: the engine line states the index's cells, bytes
    and share of the plane, and the tally counts one posted gather a batch,
    the sums written and read back only where the finish runs apart."""
    db, _, reads = fx
    _take(monkeypatch, route)
    save(db, tmp_path / "DB.eptk")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    assert main(["place", "-i", str(tmp_path / "DB.eptk"), "-o", str(tmp_path), "--platform",
                 "cpu", "--batch-size", "11", "--pair-plane", "off", "--verbose",
                 str(tmp_path / "q.fasta")]) == 0
    text = capsys.readouterr().out
    engine = next(line for line in text.splitlines() if line.startswith("Engine:"))
    assert "(1 device(s), dense), posted cells " in engine and "% of the plane)" in engine
    assert f"gathers: {route} {-(-len(reads) // 11)}" in text
    assert ("sums written and read back: " in text) == (route == "posted")
