"""Amino placement and DNA k >= 14 on the CPU, held to the JAX package and the oracle.

The fixture is ``tests/test_jax_engine.py::TestAminoCodesPath``'s: 48 leaves,
amino k = 6 (and k = 9, 39-bit keys past shift 16), reads sampled from the
reference plus the "amb" (X), "ambB" (B), "short" and "nohit" reads. A DNA
k = 14 database takes the same codes path. On each:

* the placer's flags (route, codes tokenizer, codes pair plane, shifted,
  int16) are ``JaxPlacer``'s under the same config, its plane is bit-equal to
  ``JaxPlacer._plane_s`` and its radix tables to ``JaxPlacer._dev_radix``;
* the codes steps, fed the JAX placer's own plane, radix tables and staged
  batch, give its rows bit for bit and match ``_place_batch_dense_codes``
  and ``_place_batch_dense_codes_paired``: ids equal where no near-tie hides
  them, scores within 1e-5 (f32 sums in another order);
* ``TorchPlacer`` matches the oracle by the jplace_diff rule (1e-4) and
  ``JaxPlacer``: the codes path, the host tokenizer (equal to the device
  path), the codes pair plane, the int16 plane, bf16 (the best edge), the
  classic plane, the device lookup and the CSR route; a key set with a radix
  bucket of more than 32 keys takes the host route, as in JAX;
* ``ShardedTorchPlacer`` on 1x1 and 1x4 meshes matches ``ShardedJaxPlacer``
  and the oracle, on the dense rows step and on the hash-sharded CSR;
* ``python -m epik_tpu_torch place -s amino`` matches the JAX CLI.
"""

import numpy as np
import pytest
import torch

from epik_tpu.cli.main import place_queries as jax_place_queries
from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer, device_tokenize_codes
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, reads_from_reference, reference_like_db
from epik_tpu.io.db import save
from epik_tpu.ops.radix_lookup import radix_lookup_dispatch
from epik_tpu.parallel import sharding as jax_sharding
from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh
from epik_tpu.tools.jplace_diff import jplace_diff, parse_jplace

from epik_tpu_torch.cli.main import main as port_main
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.state import plane_state_from_numpy
from epik_tpu_torch.engine.step import (
    dense_gather,
    place_batch_dense_codes,
    place_batch_dense_codes_paired,
)
from epik_tpu_torch.engine.tables import enumerate_pairs_generic
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.ops.radix_lookup import DeviceRadix
from epik_tpu_torch.ops.tokenize import tokenize_radix, tokenize_radix_paired
from epik_tpu_torch.parallel.mesh import make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from test_torch_dense import assert_pack_close, jplace_close, same_placements, top_edges_close

CONFIGS = {
    "codes": {},
    "host": dict(tokenize_where="host"),
    "pair_on": dict(pair_plane="on"),
    "int16": dict(precision="int16"),
    "bf16": dict(precision="bf16"),
    "classic": dict(plane_mode="classic"),
    "lookup_device": dict(lookup_where="device"),
    "csr": dict(dense_db="off"),
}
TREE = "((A:0.1,B:0.2):0.3,(C:0.4,D:0.1):0.2):0.0;"


def _amino(k: int, seed: int):
    db, ref = reference_like_db(num_leaves=48, kmer_size=k, ref_length=20_000,
                                mean_posting_len=6.0, sequence_type="amino", seed=seed)
    reads = reads_from_reference(ref, 60, length=90, mutation_rate=0.04,
                                 sequence_type="amino", seed=seed + 1)
    reads += [("amb", reads[0][1][:30] + b"X" + reads[0][1][31:]),
              ("ambB", b"B" + reads[1][1][:50]),
              ("short", b"AC"), ("nohit", b"W" * 40)]
    return db, reads


def _dna14():
    db, ref = reference_like_db(num_leaves=24, kmer_size=14, ref_length=12_000,
                                mean_posting_len=6.0, seed=141)
    reads = reads_from_reference(ref, 50, length=81, mutation_rate=0.03, seed=142)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
              ("short", b"ACGTACG"), ("nohit", b"T" * 40),
              ("part", reads[2][1][:29])]  # its windows past 29 bases are bad
    return db, reads


@pytest.fixture(scope="module")
def dbs():
    """name -> (db, tree, reads, oracle output)."""
    out = {}
    for name, (db, reads) in (("k6", _amino(6, 21)), ("k9", _amino(9, 41)),
                              ("k14", _dna14())):
        tree = parse_newick(db.tree())
        out[name] = (db, tree, reads, ReferencePlacer(db, tree).place(reads))
    return out


@pytest.fixture(scope="module")
def placers(dbs):
    """(db name, config name) -> (JaxPlacer, TorchPlacer), built on first use."""
    cache = {}

    def get(db_name, cfg_name):
        if (db_name, cfg_name) not in cache:
            db, tree, _, _ = dbs[db_name]
            kw = CONFIGS[cfg_name]
            cache[db_name, cfg_name] = (
                JaxPlacer(db, tree, config=JaxConfig(**kw)),
                TorchPlacer(db, tree, config=PlacerConfig(**kw), device="cpu"))
        return cache[db_name, cfg_name]

    return get


def _seqs(reads):
    return list(dict.fromkeys(s for _, s in reads))


def _jax_route(jp) -> str:
    return "dense" if jp._dense_db else "tiles" if jp._tiles_mode else "csr"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---- flags, planes and radix tables ---------------------------------------------------


@pytest.mark.parametrize("db_name,cfg_name", [("k6", c) for c in CONFIGS]
                         + [("k9", "codes"), ("k14", "codes"), ("k14", "pair_on")])
def test_flags_plane_and_radix_match_jax(dbs, placers, db_name, cfg_name):
    jp, port = placers(db_name, cfg_name)
    assert port.route == _jax_route(jp)
    assert (port._fast_bytes, port._fast_codes, port._paired_codes) == (
        jp._fast_bytes, jp._fast_codes, jp._paired_codes)
    if port.route != "dense":
        return
    assert (port._shifted, port._plane_q) == (jp._shifted, jp._plane_q)
    got, want = port.state.plane, np.asarray(jp._plane_s)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)
    if port._fast_codes:
        st = port.state
        for mine, theirs, idx in ((st.radix, jp._dev_radix, jp._radix),
                                  (st.pair_radix, jp._dev_pair_radix, jp._pair_radix)):
            if idx is None:
                assert mine is None
                continue
            assert (mine.shift, mine.n_probe, mine.off_bits) == idx.dispatch_args()
            np.testing.assert_array_equal(mine.arr1.numpy(), np.asarray(theirs[0]))
            np.testing.assert_array_equal(mine.arr2.numpy(), np.asarray(theirs[1]))
        assert st.n_pairs == jp._n_pairs
    expect = {"codes": True, "pair_on": True, "int16": True}.get(cfg_name, False)
    assert port._fast_codes == expect
    assert port._paired_codes == (cfg_name == "pair_on")


def test_radix_forms_of_the_fixtures(placers):
    """The fixtures reach the low-pair-overlap form (amino k = 6 and DNA
    k = 14, their pair keys too) and the generic probe loop (amino k = 9,
    shift > 16); ``tests/test_torch_radix.py`` reaches the packed form."""
    for name in ("k6", "k14"):
        st = placers(name, "pair_on")[1].state
        assert st.radix.form == st.pair_radix.form == "lowpair"
    k9 = placers("k9", "codes")[1].state.radix
    assert k9.form == "generic" and k9.shift > 16 and k9.n_probe > 1


# ---- the codes steps on the JAX placer's state ------------------------------------------


def _radix_of(jp, arrays, first: int) -> DeviceRadix:
    return DeviceRadix(_t(arrays[first]), _t(arrays[first + 1]), *jp._radix.dispatch_args())


@pytest.mark.parametrize("db_name,cfg_name", [("k6", "codes"), ("k9", "codes"),
                                              ("k6", "int16"), ("k14", "codes")])
def test_codes_step_matches_jax(dbs, placers, db_name, cfg_name):
    """``place_batch_dense_codes`` against ``_place_batch_dense_codes`` on the
    JAX placer's plane, radix tables and staged (R-padded) batch: the rows of
    the tokenizer and the lookup bit-equal to JAX's, the packs close."""
    _, _, reads, _ = dbs[db_name]
    jp, _ = placers(db_name, cfg_name)
    fn, arrays, _, _, K = jp._stage_codes(_seqs(reads))
    kw = fn.keywords
    assert fn.func.__name__ == "_place_batch_dense_codes"
    want = np.asarray(fn(*arrays))
    plane, _, _, buf, arows = (np.array(a) for a in arrays)
    radix = _radix_of(jp, arrays, 1)
    buf_t = torch.from_numpy(buf)
    st = plane_state_from_numpy(plane, n_keys=kw["num_kmers"], device="cpu",
                                scale=float(jp._plane_scale), radix=radix)
    a, b, ok, _ = device_tokenize_codes(arrays[3], k=kw["k"], sigma=kw["sigma"],
                                        Lmax=kw["Lmax"])
    rows_j = np.where(np.asarray(ok), np.asarray(radix_lookup_dispatch(
        arrays[1], arrays[2], a, b, shift=kw["shift"], n_probe=kw["n_probe"],
        off_bits=kw["off_bits"], n_keys=kw["num_kmers"])), kw["num_kmers"])
    rows, _ = tokenize_radix(buf_t, radix, k=kw["k"], sigma=kw["sigma"], Lmax=kw["Lmax"],
                             num_kmers=kw["num_kmers"])
    np.testing.assert_array_equal(rows.numpy(), rows_j)
    assert kw["Amax"] > 0
    reset_launch_counts()
    got = place_batch_dense_codes(
        st.plane, st.radix, buf_t, torch.from_numpy(arows), B=kw["B"], K=K, Amax=kw["Amax"],
        k=kw["k"], sigma=kw["sigma"], Lmax=kw["Lmax"], num_kmers=kw["num_kmers"],
        log_eps=kw["log_eps"], eps=kw["eps"], plane_scale=kw["plane_scale"],
        gather=dense_gather(st.plane, kw["B"], K, shifted=True)).numpy()
    assert not any(launch_counts().values())  # the plain versions on the CPU
    assert_pack_close(got, want, K, slim=True)


def _jax_slot_rows(arrays, kw):
    """JAX's slot rows of ``_place_batch_dense_codes_paired`` (:1416-1451),
    composed from its tokenizer and lookup."""
    n, n_pairs = kw["num_kmers"], kw["n_pairs"]
    a, b, ok, _ = device_tokenize_codes(arrays[5], k=kw["k"], sigma=kw["sigma"],
                                        Lmax=kw["Lmax"])
    r = np.where(np.asarray(ok), np.asarray(radix_lookup_dispatch(
        arrays[1], arrays[2], a, b, shift=kw["shift"], n_probe=kw["n_probe"],
        off_bits=kw["off_bits"], n_keys=n)), n)
    W = r.shape[1]
    Wp = (W + 1) // 2
    r = np.pad(r, ((0, 0), (0, 2 * Wp - W)), constant_values=n)
    single = np.where(r[:, 0::2] != n, r[:, 0::2], r[:, 1::2])
    a11, b11, ok11, _ = device_tokenize_codes(arrays[5], k=kw["k"] + 1, sigma=kw["sigma"],
                                              Lmax=kw["Lmax"])
    pad = 2 * Wp - 1 - a11.shape[1]
    a11, b11, ok11 = (np.pad(np.asarray(x), ((0, 0), (0, pad)))[:, 0::2]
                      for x in (a11, b11, ok11))
    pidx = np.asarray(radix_lookup_dispatch(
        arrays[3], arrays[4], a11, b11, shift=kw["p_shift"], n_probe=kw["p_probe"],
        off_bits=kw["p_off_bits"], n_keys=n_pairs))
    return np.where(ok11 & (pidx < n_pairs), n + 1 + pidx, single)


@pytest.mark.parametrize("db_name", ["k6", "k14"])
def test_codes_paired_step_matches_jax(dbs, placers, db_name):
    """``place_batch_dense_codes_paired`` against
    ``_place_batch_dense_codes_paired`` on the JAX placer's pair plane, radix
    tables and staged batch: the slot rows bit-equal to JAX's, the packs
    close."""
    _, _, reads, _ = dbs[db_name]
    jp, _ = placers(db_name, "pair_on")
    fn, arrays, _, _, K = jp._stage_codes(_seqs(reads))
    kw = fn.keywords
    assert fn.func.__name__ == "_place_batch_dense_codes_paired"
    want = np.asarray(fn(*arrays))
    radix = _radix_of(jp, arrays, 1)
    pair_radix = DeviceRadix(_t(arrays[3]), _t(arrays[4]), *jp._pair_radix.dispatch_args())
    buf_t, arows_t = _t(arrays[5]), _t(arrays[6])
    rows, _ = tokenize_radix_paired(buf_t, radix, pair_radix, k=kw["k"], sigma=kw["sigma"],
                                    Lmax=kw["Lmax"], num_kmers=kw["num_kmers"],
                                    n_pairs=kw["n_pairs"])
    want_rows = _jax_slot_rows(arrays, kw)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert (want_rows > kw["num_kmers"]).any()  # pair rows taken
    got = place_batch_dense_codes_paired(
        _t(arrays[0]), radix, pair_radix, buf_t, arows_t, B=kw["B"], K=K, Amax=kw["Amax"],
        k=kw["k"], sigma=kw["sigma"], Lmax=kw["Lmax"], num_kmers=kw["num_kmers"],
        n_pairs=kw["n_pairs"], log_eps=kw["log_eps"], eps=kw["eps"],
        gather=dense_gather(_t(arrays[0]), kw["B"], K, shifted=True)).numpy()
    assert_pack_close(got, want, K, slim=True)


@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_paired_slot_rows_at_short_widths(placers, W):
    """W < 2 keeps single slots; an odd W a last slot with one window; each
    slot the pair row or the first hitting window's row."""
    _, port = placers("k6", "pair_on")
    st = port.state
    db = port.db
    k, Lmax = port.k, port.k + W - 1
    rng = np.random.default_rng(W)
    key11 = enumerate_pairs_generic(db.keys, k, 20)[2]
    codes = np.zeros((6, Lmax), np.uint8)
    for r in range(6):  # each read starts with a pair's (k+1)-mer, then random codes
        key = int(key11[rng.integers(key11.size)])
        digits = [(key // 20 ** (k - j)) % 20 for j in range(k + 1)]
        codes[r] = (digits + list(rng.integers(0, 20, Lmax)))[:Lmax]
    codes[5, -1] = 0xFF  # a bad last window
    buf = np.concatenate([codes, np.full((6, 1), Lmax, np.uint8), np.zeros((6, 1), np.uint8)],
                         axis=1)
    buf_t = torch.from_numpy(buf)
    single, _ = tokenize_radix(buf_t, st.radix, k=k, sigma=20, Lmax=Lmax,
                               num_kmers=st.n_keys)
    got, _ = tokenize_radix_paired(buf_t, st.radix, st.pair_radix, k=k, sigma=20, Lmax=Lmax,
                                   num_kmers=st.n_keys, n_pairs=st.n_pairs)
    assert got.shape == (6, (W + 1) // 2)
    s = single.numpy()
    s = np.pad(s, ((0, 0), (0, 2 * got.shape[1] - W)), constant_values=st.n_keys)
    first = np.where(s[:, 0::2] != st.n_keys, s[:, 0::2], s[:, 1::2])
    g = got.numpy()
    pair = g > st.n_keys
    np.testing.assert_array_equal(g[~pair], first[~pair])
    if W >= 2:
        assert pair[:5, 0].all()  # every read but the bad one starts with a pair
    if W % 2:
        assert not pair[:, -1].any()
    if W == 2:
        assert not pair[5, 0]  # its second window is bad


# ---- the placer --------------------------------------------------------------------------


@pytest.mark.parametrize("db_name,cfg_name", [
    ("k6", "codes"), ("k9", "codes"), ("k6", "host"), ("k6", "pair_on"), ("k6", "int16"),
    ("k6", "bf16"), ("k6", "classic"), ("k6", "lookup_device"), ("k6", "csr"),
    ("k14", "codes"), ("k14", "pair_on")])
def test_placer_matches_jax_and_oracle(dbs, placers, db_name, cfg_name):
    _, _, reads, oracle = dbs[db_name]
    jp, port = placers(db_name, cfg_name)
    got = port.place(reads)
    want = jp.place(reads)
    if cfg_name == "bf16":
        top_edges_close(want, got, len(reads))
        return
    jplace_close(oracle, got)
    same_placements(want, got)
    if cfg_name == "host":  # the host tokenizer places as the codes path does
        same_placements(placers(db_name, "codes")[1].place(reads), got)


def test_reads_the_codes_path_cannot_take(placers, dbs):
    """A batch of reads all shorter than k takes the host tokenizer; a batch
    where only some are shorter keeps the codes path, their m wrapped
    (quirk Q1)."""
    db, tree, reads, _ = dbs["k6"]
    _, port = placers("k6", "codes")
    ref = ReferencePlacer(db, tree)
    assert port._stage_codes([b"AC", b"ACDE"]) is None
    for batch in ([("a", b"AC"), ("b", b"")], [("a", b"AC"), ("r", reads[3][1])]):
        jplace_close(ref.place(batch), port.place(batch))


def test_skewed_key_set_takes_the_host_route():
    """40 amino 4-mers in one radix bucket (more than 32 probes): JAX leaves
    the codes path, and so does the port; both place as the oracle."""
    entries = {k: [(k % 5, -0.5 - (k % 7) * 0.3), ((k + 2) % 5, -2.0)] for k in range(40)}
    entries[159_999] = [(1, -1.0)]
    db = build_db(entries, TREE, kmer_size=4, sequence_type="amino")
    tree = parse_newick(TREE)
    jp = JaxPlacer(db, tree)
    port = TorchPlacer(db, tree, device="cpu")
    assert jp._shifted and not jp._fast_codes
    assert port.route == "dense" and port._shifted and not port._fast_codes
    reads = [("r", b"AAAAAAACAD"), ("s", b"YYYYAAAA"), ("t", b"AAXAAC")]
    got = port.place(reads)
    jplace_close(ReferencePlacer(db, tree).place(reads), got)
    same_placements(jp.place(reads), got)


# ---- the sharded placer -------------------------------------------------------------------


@pytest.mark.parametrize("n_model", [1, 4])
@pytest.mark.parametrize("route", ["dense", "csr"])
def test_sharded_matches_jax_and_oracle(dbs, n_model, route):
    """Amino on the column-sharded dense plane (the host-tokenized rows step)
    and on the hash-sharded CSR tables, against ``ShardedJaxPlacer`` on the
    same mesh shape and the oracle."""
    db, tree, reads, oracle = dbs["k6"]
    kw = {} if route == "dense" else dict(dense_db="off")
    port = ShardedTorchPlacer(db, tree, make_mesh(1, n_model,
                                                  devices=[torch.device("cpu")] * n_model),
                              config=PlacerConfig(**kw))
    assert port.route == route and not port._fast_bytes
    jax_p = jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(1, n_model),
                                          config=JaxConfig(**kw))
    got = port.place(reads)
    jplace_close(oracle, got)
    jplace_close(jax_p.place(reads), got, eps=1e-5)


# ---- the CLI ------------------------------------------------------------------------------


def test_cli_amino_matches_jax_cli(dbs, tmp_path, capsys):
    db, _, reads, _ = dbs["k6"]
    save(db, tmp_path / "A.eptk")
    with open(tmp_path / "q.fasta", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    rc = port_main(["place", "-s", "amino", "-i", str(tmp_path / "A.eptk"), "-o",
                    str(tmp_path / "port"), "--platform", "cpu", "--batch-size", "32",
                    str(tmp_path / "q.fasta")])
    assert rc == 0
    assert "(1 device(s), dense)" in capsys.readouterr().out
    assert jax_place_queries(str(tmp_path / "A.eptk"), "amino", 1.5, 1.0,
                             str(tmp_path / "jax"), 1, "", str(tmp_path / "q.fasta"),
                             batch_size=32, engine="jax") == 0
    a = tmp_path / "port" / "placements_q.fasta.jplace"
    b = tmp_path / "jax" / "placements_q.fasta.jplace"
    assert set(parse_jplace(str(a))) == set(parse_jplace(str(b))) == {n for n, _ in reads}
    for x, y in ((a, b), (b, a)):
        res = jplace_diff(str(x), str(y))
        assert res.clean, res.mismatches[:5]
