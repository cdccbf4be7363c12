"""``TorchPlacer``: the placement engine of the port on PyTorch.

Ports ``epik_tpu.engine.placer.JaxPlacer`` for DNA databases along three
routes, chosen at construction by the JAX package's rules (placer.py:1796-2026)
with the port's memory budgets:

* ``dense`` -- for a database whose dense plane fits the budget
  (``dense_db="auto"`` with ``accumulate="auto"``, or ``dense_db="on"``).
  JAX's flags pick the plane and the step: the shifted plane (f32, or int16
  with ``precision="int16"``) when the rows are resolved on the host
  (``lookup_where``) and every stored score is >= log10(eps), else the
  classic plane (f32, or bf16 with ``precision="bf16"``); the device
  tokenizer (``tokenize_where``, k <= 13) over the pair plane when it is
  shifted f32, k <= 12 and it fits its budget
  (``place_batch_dense_paired``), else over the direct key -> row table
  (``place_batch_dense_bytes``). A batch the device tokenizer cannot take
  (every read shorter than k, a read over 65,535 bp), and every batch
  without it, is tokenized on the host: plane rows found on the host
  (``place_batch_dense_rows``) or, with ``lookup_where="device"``, keys looked
  up in the cuckoo table on the device (``place_batch_device_densedb``);
* ``tiles`` -- the big-tree posting-tile path, when the dense plane is not
  taken and the tiles fit: every clean batch runs the tile step (packed or
  f32 payload); a batch holding IUPAC reads splits, its ambiguous reads going
  to the CSR step; a batch the tile step cannot take (reads too long for the
  packed payload's exact integer sums, every read shorter than k, a read over
  65,535 bp) goes to the CSR step whole;
* ``csr`` -- every batch through the CSR step (cuckoo lookup, per-read
  posting cells, segment accumulate with counts), when neither fits.

``place`` -> ``place_async`` (dedup, host staging, the device step) ->
``place_wait`` (one result transfer, budget retries, assembly). Options and
databases of paths not yet ported raise ``NotImplementedError`` naming the
ROADMAP.md queue item that ports them.

The device is explicit. ``device="cuda"`` without CUDA raises; the placer
never carries on on the CPU. On a CUDA device every kernel of a step runs as
hand-written CUDA (``epik_tpu_torch/kernels``); on the CPU the kernels' plain
PyTorch versions run.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from ..core.alphabet import get_alphabet
from ..core.scoring import score_threshold
from ..kernels.accumulate_packed import MAX_PACKED_BRANCHES, tile_width
from ..ops.csr import ORDER_INF
from .config import PlacerConfig, check_supported, device_budget
from .outputs import (
    _Pending,
    _SplitPending,
    assemble_arrays,
    merge_split,
    unpack_outputs,
    unpack_outputs_slim,
)
from .staging import HostStaging, _bucket, _bucket_lmax, key_matrix, pad_i32, pad_u64_split
from .state import CsrState, PlaneState, build_csr_state, build_plane_state, pair_tables
from .step import (
    place_batch_csr,
    place_batch_dense_bytes,
    place_batch_dense_paired,
    place_batch_dense_rows,
    place_batch_device_densedb,
    place_batch_tiles_bytes,
)
from .tables import direct_table
from .tiles import Q_MAX, TileState, build_tile_state, tile_bytes
from .types import PlacedCollection

__all__ = ["TorchPlacer"]

#: the packed read format stores lengths as uint16
_MAX_READ_LEN = 0xFFFF
#: largest k with a pair plane: the (k+1)-mer combo table is 4**(k+1) int32
_MAX_PAIR_K = 12
#: largest k with a direct key -> row table (4**13 int32 = 268 MB)
_MAX_DIRECT_K = 13
#: keys JAX's radix lookup (the generic-alphabet device tokenizer) takes
_MAX_RADIX_KEY_BITS = 48
#: longest posting list the tiles take (placer.py:1844)
_MAX_TILE_PLEN = 128


def _wrapped_m(m_signed: np.ndarray) -> np.ndarray:
    """The correction term's window count as f32, size_t-wrapped (quirk Q1):
    float32(2**64 - small) == float32(2**64), so the wrap collapses."""
    return np.where(
        m_signed >= 0, m_signed.astype(np.float32),
        np.float32(float(1 << 64)) + m_signed.astype(np.float32),
    ).astype(np.float32)


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchPlacer(HostStaging):
    """Single-device placer with the reference's ``place(batch)`` surface.

    ``state``: a prebuilt :class:`~.state.PlaneState` (the dense route, e.g.
    from :func:`~.state.plane_state_from_numpy`) or
    :class:`~.tiles.TileState` (the tiles route, e.g. from
    :func:`~.tiles.tile_state_from_numpy`) instead of building it from
    ``db``. ``route`` is ``"dense"``, ``"tiles"`` or ``"csr"``."""

    def __init__(self, db, tree, keep_at_most: int | None = None,
                 keep_factor: float | None = None,
                 config: PlacerConfig | None = None, *, device,
                 state: PlaneState | TileState | None = None):
        self.device = _resolve_device(device)
        self.db = db
        self.tree = tree
        # copy: never mutate a caller-supplied config; explicit kwargs win
        self.config = dataclasses.replace(config) if config else PlacerConfig()
        if keep_at_most is not None:
            self.config.keep_at_most = keep_at_most
        if keep_factor is not None:
            self.config.keep_factor = keep_factor
        check_supported(self.config)
        self.alphabet = get_alphabet(db.sequence_type)
        self.k = db.kmer_size
        self.B = tree.get_node_count()
        # quirk Q10: threshold from db.omega() after load
        self.eps = np.float32(score_threshold(db.omega, self.k, self.alphabet.sigma))
        self.log_eps = np.float32(np.log10(self.eps))
        # pendant/distal precompute (reference: place.cpp:98-125)
        num, tot = tree.tree_index()
        self.distal = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant = mean + self.distal
        self._init_staging()
        lens = np.diff(db.row_off)
        self._avg_plen = float(lens.mean()) if lens.size else 1.0
        self._max_plen = int(lens.max()) if lens.size else 0
        #: budget-overflow re-dispatches (the tiles' OV, the CSR step's P/PA)
        self.overflow_retries = 0
        self._retry_lock = threading.Lock()
        self._csr_cache: CsrState | None = None
        self.state: PlaneState | None = None
        self.tiles: TileState | None = None
        # JAX's dense flags (placer.py:1807-1823, 1881-1890, 1973-1982), set
        # by _route for the dense route
        self._host_lookup = self._fast_bytes = self._shifted = self._plane_q = False
        self._paired = False
        self.route = self._route(state)

    # -- routing (placer.py:1796-2026) ---------------------------------------------

    def _route(self, state) -> str:
        cfg = self.config
        db = self.db
        if self.alphabet.sigma != 4:
            raise NotImplementedError(
                "amino databases are not ported yet: ROADMAP.md queue 1 item 8")
        n_keys = db.num_kmers
        packed = (cfg.tile_payload in ("auto", "packed")
                  and tile_width(self.B) - 1 < MAX_PACKED_BRANCHES)
        if cfg.tile_payload == "packed" and not packed:
            raise ValueError(
                f"tile_payload='packed' needs branch ids < 2**15 (padded width "
                f"{tile_width(self.B)}); use 'auto' or 'f32'")
        plane_w = -(-self.B // 128) * 128
        base_bytes = (n_keys + 1) * plane_w * 4
        budget = device_budget(self.device)
        dense_budget = budget if cfg.dense_db_budget is None else cfg.dense_db_budget
        # shifted-score validity: every stored score >= log10(eps) (the load
        # contract, quirk Q10) -- hand-built fixtures can violate it
        shift_ok = db.scores.size == 0 or float(db.scores.min()) >= float(self.log_eps)
        # an explicit accumulate choice pins the tiles/CSR engines; only
        # "auto" lets the dense plane take over
        if cfg.dense_db == "on" or (cfg.dense_db == "auto" and cfg.accumulate == "auto"
                                    and base_bytes <= dense_budget):
            if cfg.dense_db == "on" and base_bytes > dense_budget:
                raise ValueError(
                    f"dense_db='on' but the dense plane needs {base_bytes} bytes "
                    f"({n_keys + 1} rows x {plane_w} f32), over the budget of "
                    f"{dense_budget} bytes on {self.device}")
            self._dense_flags(shift_ok)
            self.state = state if state is not None else self._build_state(budget)
            self._check_state()
            return "dense"
        if (shift_ok and self.k <= _MAX_DIRECT_K and n_keys > 0
                and cfg.precision == "exact" and cfg.tokenize_where in ("auto", "device")
                and self._max_plen <= _MAX_TILE_PLEN
                and tile_bytes(n_keys, self._max_plen) <= dense_budget):
            if packed and cfg.pair_plane == "on" and self.k + 1 <= _MAX_DIRECT_K:
                raise NotImplementedError(
                    "pair_plane='on' selects the pair-fused posting tiles "
                    "(_place_batch_tiles_paired), not ported yet: ROADMAP.md "
                    "queue 1 item 6")
            self.tiles = state if state is not None else build_tile_state(
                db, k=self.k, B=self.B, log_eps=self.log_eps, packed=packed,
                device=self.device)
            return "tiles"
        return "csr"

    def _dense_flags(self, shift_ok: bool) -> None:
        """JAX's flags of the dense route, for DNA (placer.py:1807-1823,
        1881-1890, 1949-1955): the host row lookup, the device tokenizer, the
        shifted plane, the int16 plane. The pair plane's fit is decided when
        it is built (:meth:`_build_state`)."""
        cfg = self.config
        self._host_lookup = cfg.lookup_where in ("auto", "host")
        self._fast_bytes = (cfg.tokenize_where in ("auto", "device")
                            and self.k <= _MAX_DIRECT_K)
        # the device-cuckoo dense path stays classic; int16 is shifted-only
        self._shifted = ((cfg.plane_mode == "shifted" or cfg.precision == "int16")
                         and cfg.precision in ("exact", "int16")
                         and self._host_lookup and shift_ok)
        self._plane_q = self._shifted and cfg.precision == "int16"
        if (self._shifted and not self._fast_bytes and cfg.tokenize_where != "host"
                and self.db.num_kmers > 0 and 2 * self.k < _MAX_RADIX_KEY_BITS):
            raise NotImplementedError(
                f"k={self.k} has no direct key -> row table (k <= {_MAX_DIRECT_K}): "
                "JAX tokenizes such a database on the device through its radix "
                "lookup (_place_batch_dense_codes), not ported yet: ROADMAP.md "
                "queue 1 item 8")

    def _build_state(self, budget: int) -> PlaneState:
        """The plane of the dense flags: the pair plane when JAX builds it
        (placer.py:1973-2026) and it fits ``pair_plane_budget`` (or the
        device's budget), else the unpaired plane with the direct table for
        the device tokenizer."""
        cfg = self.config
        kw = dict(k=self.k, B=self.B, log_eps=self.log_eps, shifted=self._shifted,
                  precision=cfg.precision, device=self.device)
        if (self._fast_bytes and self._shifted and not self._plane_q
                and cfg.pair_plane in ("auto", "on") and self.k <= _MAX_PAIR_K
                and self.db.num_kmers > 0):
            pu, pv, combo = pair_tables(self.db, self.k)
            n_pairs = int(pu.shape[0])
            plane_w = -(-self.B // 128) * 128
            paired_bytes = (self.db.num_kmers + 1 + n_pairs) * plane_w * 4 + combo.nbytes
            pair_budget = budget if cfg.pair_plane_budget is None else cfg.pair_plane_budget
            if cfg.pair_plane == "on" and paired_bytes > pair_budget:
                raise ValueError(
                    f"pair_plane='on' but the pair plane ({n_pairs} pair rows) needs "
                    f"{paired_bytes} bytes with the combo table, over the budget of "
                    f"{pair_budget} bytes on {self.device}; use pair_plane='auto'")
            if n_pairs > 0 and paired_bytes <= pair_budget:
                self._paired = True
                return build_plane_state(self.db, pairs=(pu, pv, combo), **kw)
        direct = (direct_table(self.db.keys, self.k, self.db.num_kmers)
                  if self._fast_bytes else None)
        return build_plane_state(self.db, direct=direct, **kw)

    def _check_state(self) -> None:
        """A state handed in must be the plane the flags choose."""
        st = self.state
        want = (torch.int16 if self._plane_q else torch.bfloat16
                if self.config.precision == "bf16" else torch.float32)
        self._paired = st.combo is not None
        if (st.plane.dtype != want or (self._paired and not (self._fast_bytes
                                                              and self._shifted))
                or (self._fast_bytes and not self._paired and st.direct is None)):
            raise ValueError(
                f"the dense state ({st.plane.dtype} plane, "
                f"{'pair' if self._paired else 'unpaired'}) is not the plane of this "
                f"config ({want}, shifted={self._shifted}, device tokenizer="
                f"{self._fast_bytes})")

    @property
    def csr(self) -> CsrState:
        """The CSR step's device state (cuckoo table, postings), built on
        first use: the tiles route needs it only for ambiguous reads and
        batches the tile step cannot take."""
        if self._csr_cache is None:
            with self._lazy_lock:
                if self._csr_cache is None:
                    self._csr_cache = build_csr_state(self.db, device=self.device)
        return self._csr_cache

    # -- the place surface ----------------------------------------------------

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """Synchronous place (reference surface: place.cpp:201)."""
        return self.place_wait(self.place_async(records))

    def place_async(self, records: list[tuple[str, bytes]]):
        """Stage a batch and enqueue its device step without waiting for it."""
        # dedup by content (quirk Q8; reference: place.cpp:73-81,207)
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map.keys())
        if not seqs:
            return _Pending(sequence_map, [], None, None, self._K())
        if self.route == "dense":
            if self._fast_bytes:
                pending = self._place_async_dense(sequence_map, seqs)
                if pending is not None:
                    return pending
            return self._place_async_dense_host(sequence_map, seqs)
        if self.route == "tiles":
            pending = self._place_async_tiles(sequence_map, seqs)
            if pending is not None:
                return pending
        return self._place_async_csr(sequence_map, seqs)

    def _K(self) -> int:
        return min(self.config.keep_at_most, self.B)

    def _place_async_dense(self, sequence_map, seqs) -> _Pending | None:
        """The device-tokenizer dense step (JAX ``_place_async_bytes``,
        placer.py:2447-2476, 2575-2612): the pair plane, or the unpaired
        plane through the direct table. None for a batch the device tokenizer
        cannot take; the caller tokenizes it on the host."""
        staged = self._stage_bytes(seqs)
        if staged is None:
            return None
        buf, arows, Amax, Lmax, m_signed = staged
        dev = self.device
        st = self.state
        buf_t, arows_t = torch.from_numpy(buf).to(dev), torch.from_numpy(arows).to(dev)
        kw = dict(B=self.B, K=self._K(), Amax=Amax, k=self.k, Lmax=Lmax,
                  num_kmers=st.n_keys, log_eps=float(self.log_eps), eps=float(self.eps))
        if self._paired:
            out = place_batch_dense_paired(st.plane, st.combo, buf_t, arows_t, **kw)
        else:
            out = place_batch_dense_bytes(st.plane, st.direct, buf_t, arows_t,
                                          shifted=self._shifted, plane_scale=st.scale, **kw)
        return _Pending(sequence_map, seqs, m_signed, out, self._K())

    def _stage_bytes(self, seqs):
        """Host staging of the device-tokenizer dense steps (JAX
        placer.py:2478-2612): one packed uint8 buffer, plus the host-tokenized
        ambiguity rows of the reads that hold IUPAC characters (quirks Q6/Q7).

        Returns (buf, arows, Amax, Lmax, m_signed), or None where JAX returns
        None (every read shorter than k, or a read longer than the packed
        format's uint16 length). Unlike the JAX version, R is not padded to a
        bucket: eager PyTorch has no compile cache."""
        R = len(seqs)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R)
        Lmax_true = int(lens_arr.max())
        if Lmax_true < self.k or Lmax_true > _MAX_READ_LEN:
            return None
        Lmax = _bucket_lmax(Lmax_true)
        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R)
        if amb_mask.any():
            idxs = np.flatnonzero(amb_mask)
            tok = self._tokenize([seqs[i] for i in idxs])
            a_keys = tok.amb_keys
            a_read = idxs[tok.amb_read] if a_keys.size else tok.amb_read
            apr = int(np.bincount(a_read, minlength=R).max()) if a_keys.size else 0
            Amax = _bucket(apr, 8) if a_keys.size else 0
            arows = self._rows_matrix(a_keys, a_read, R, Amax)
        else:
            Amax = 0
            arows = np.zeros((R, 0), np.int32)
        return buf, arows, Amax, Lmax, m_signed

    def _place_async_dense_host(self, sequence_map, seqs) -> _Pending:
        """The dense branch of JAX ``_place_async_classic`` (placer.py:2369-2420):
        the host tokenizer, then the window and ambiguous keys of each read in
        processing order, as plane rows found on the host
        (``place_batch_dense_rows``) or, with ``lookup_where="device"``, as
        keys the device looks up (``place_batch_device_densedb``). A read
        shorter than k keeps no window and takes the Q1-wrapped m."""
        R = len(seqs)
        tokens = self._tokenize(seqs)
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        m_f32 = torch.from_numpy(_wrapped_m(m_signed)).to(self.device)
        wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if tokens.exact_read.size else 1
        apr = int(np.bincount(tokens.amb_read, minlength=R).max()) if tokens.amb_read.size else 1
        # JAX pads the window columns to a multiple of 16 (its jit cache);
        # extra zero-row slots add nothing to a sum
        Wmax = max(1, wpr)
        st = self.state
        kw = dict(B=self.B, K=self._K(), k=self.k, log_eps=float(self.log_eps),
                  eps=float(self.eps))

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        if self._host_lookup:
            Amax = _bucket(apr, 8) if tokens.amb_keys.size else 0
            rows = self._rows_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            arows = self._rows_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            out = place_batch_dense_rows(st.plane, dev(rows), dev(arows), m_f32, Amax=Amax,
                                         zero_row=st.n_keys, shifted=self._shifted,
                                         plane_scale=st.scale, **kw)
        else:
            Amax = _bucket(apr, 8)
            e_hi, e_lo = key_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            a_hi, a_lo = key_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            cs = self.csr
            out = place_batch_device_densedb(
                cs.table, cs.seed1, cs.seed2, st.plane, *(dev(a.astype(np.int64)) for a in
                                                         (e_hi, e_lo, a_hi, a_lo)),
                m_f32, zero_row=st.n_keys, **kw)
        return _Pending(sequence_map, seqs, m_signed, out, self._K())

    def _place_async_tiles(self, sequence_map, seqs):
        """The tiles branch of JAX ``_place_async_bytes`` (placer.py:2447-2476).
        Returns None for a batch the tile step cannot take; the caller sends
        it to the CSR step whole."""
        staged = self._stage_tiles(seqs)
        if staged is None:
            return None
        if staged[0] == "amb_split":
            # clean reads stay on the tiles path, ambiguous reads take CSR
            amb_mask = staged[1]
            idx_a = np.flatnonzero(amb_mask)
            idx_c = np.flatnonzero(~amb_mask)
            if idx_c.size == 0:
                return None  # every read ambiguous: the whole batch goes to CSR
            seqs_c = [seqs[i] for i in idx_c]
            seqs_a = [seqs[i] for i in idx_a]
            clean = self._place_async_tiles({s: sequence_map[s] for s in seqs_c}, seqs_c)
            if clean is None:  # every clean read shorter than k
                return None
            amb = self._place_async_csr({s: sequence_map[s] for s in seqs_a}, seqs_a)
            return _SplitPending(sequence_map, seqs, idx_c, idx_a, clean, amb)
        step, OV, m_signed = staged
        budget = None if OV is None else ("tiles_ov", OV, step)
        return _Pending(sequence_map, seqs, m_signed, step(OV), self._K(), budget)

    def _stage_tiles(self, seqs):
        """The tiles branch of JAX ``_stage_bytes`` (placer.py:2478-2574).

        Returns None when the batch cannot take the tile step, ``("amb_split",
        amb_mask)`` when it holds IUPAC reads, else ``(step, OV, m_signed)``:
        ``step(OV)`` enqueues the device step with the two-level overflow
        budget OV (None, and ignored, without the two-level split)."""
        R = len(seqs)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R)
        Lmax_true = int(lens_arr.max())
        if Lmax_true < self.k or Lmax_true > _MAX_READ_LEN:
            return None
        Lmax = _bucket_lmax(Lmax_true)
        ts = self.tiles
        W = Lmax - self.k + 1
        # packed exactness gate: per-(read, branch) integer sums are bounded
        # by W * 64000 and must stay < 2**24 for the TPU kernel's f32
        # accumulator; kept as is (int32 on the card would be exact beyond
        # it) because the routing decides which numbers come out
        if ts.packed and W * Q_MAX >= 1 << 24:
            return None
        buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R)
        if amb_mask.any():
            return ("amb_split", amb_mask)
        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        step = functools.partial(
            place_batch_tiles_bytes, ts.tiles, ts.direct,
            torch.from_numpy(buf).to(self.device), ts.tiles_ov,
            B=self.B, K=self._K(), k=self.k, Lmax=Lmax, num_kmers=ts.n_keys,
            PT=ts.pt, log_eps=float(self.log_eps), packed=ts.packed, scale=ts.scale,
            PT_OV=ts.pt_ov, N_OV=ts.n_ov)
        if ts.pt_ov == 0:
            return (lambda _ov: step()), None, m_signed
        # static overflow-window budget: expected overflow windows per read
        # x2 safety, bucketed; the step reports each read's true count and
        # place_wait retries with a bigger OV on the (rare) read above it
        OV = min(W, _bucket(max(8, int(W * ts.frac_over * 2.0) + 4), 8))
        return (lambda ov: step(OV=min(ov, W))), OV, m_signed

    def _place_async_csr(self, sequence_map, seqs) -> _Pending:
        step, P, PA, m_signed = self._stage_csr(seqs)
        return _Pending(sequence_map, seqs, m_signed, step(P, PA), self._K(),
                        ("csr", P, PA, step))

    def _stage_csr(self, seqs):
        """The CSR branch of JAX ``_place_async_classic`` (placer.py:2369-2445)
        with the kernel-backed engine's per-read posting budget P.

        Returns ``(step, P, PA, m_signed)``: ``step(P, PA)`` enqueues the
        device step with those posting budgets."""
        cfg = self.config
        R = len(seqs)
        tokens = self._tokenize(seqs)
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        m_f32 = _wrapped_m(m_signed)
        n_e = tokens.exact_keys.shape[0]
        n_a = tokens.amb_keys.shape[0]
        E = _bucket(n_e, cfg.min_bucket)
        A = _bucket(n_a, cfg.min_bucket)
        est = max(1, int(self._avg_plen * cfg.budget_headroom))
        wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if n_e else 1
        P = _bucket(wpr * est, max(cfg.min_bucket, 512))
        PA = _bucket(n_a * est, cfg.min_bucket)

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.astype(np.int64)).to(self.device)

        e_hi, e_lo = pad_u64_split(tokens.exact_keys, E)
        a_hi, a_lo = pad_u64_split(tokens.amb_keys, A)
        cs = self.csr
        step = functools.partial(
            place_batch_csr, cs.table, cs.seed1, cs.seed2, cs.post_b, cs.post_s,
            cs.row_off, dev(e_hi), dev(e_lo), dev(pad_i32(tokens.exact_read, E, R)),
            dev(a_hi), dev(a_lo), dev(pad_i32(tokens.amb_read, A, R)),
            dev(pad_i32(tokens.amb_order, A, ORDER_INF)),
            torch.from_numpy(m_f32).to(self.device),
            R=R, B=self.B, K=self._K(), k=self.k, log_eps=float(self.log_eps),
            eps=float(self.eps))
        return (lambda p, pa: step(P=p, PA=pa)), P, PA, m_signed

    def _count_retry(self) -> None:
        with self._retry_lock:  # the pipeline waits on batches from several threads
            self.overflow_retries += 1

    def place_wait(self, pending):
        """Fetch a batch's result, re-running its step while a budget was too
        small (placer.py:2720-2785), and assemble its jplace rows."""
        if isinstance(pending, _SplitPending):
            return merge_split(pending, self.place_wait(pending.clean),
                               self.place_wait(pending.amb))
        if pending.out is None:
            return PlacedCollection(sequence_map=pending.sequence_map, placed_seqs=[])
        K = pending.K
        arr = pending.out.cpu().numpy()
        budget = pending.budget
        if budget is None:
            # the dense steps: the shifted plane's slim (R, 2K+3) pack or the
            # classic plane's full (R+1, 4K+2) one, whose widths differ for
            # every K >= 1 (placer.py:2753-2758)
            unpack = unpack_outputs_slim if arr.shape[1] == 2 * K + 3 else unpack_outputs
            outs = unpack(arr, K)
        elif budget[0] == "tiles_ov":
            # the last column carries each read's true overflow-window count
            _, OV, rerun = budget
            while arr.shape[0] and int(arr[:, -1].max()) > OV:
                self._count_retry()
                OV = _bucket(int(arr[:, -1].max()), 8)  # rerun clamps to W
                arr = rerun(OV).cpu().numpy()
            outs = unpack_outputs_slim(arr[:, :-1], K)
        else:
            _, P, PA, rerun = budget
            lo = max(self.config.min_bucket, 512)
            while True:
                outs = unpack_outputs(arr, K)
                e_total, a_total = outs[6], outs[7]
                if e_total <= P and a_total <= PA:
                    break
                # budget overflow: grow the budget bucket and re-run
                self._count_retry()
                P = _bucket(e_total, lo) if e_total > P else P
                PA = _bucket(a_total, self.config.min_bucket) if a_total > PA else PA
                arr = rerun(P, PA).cpu().numpy()
        scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum = outs[:6]
        return assemble_arrays(
            pending.seqs, pending.sequence_map, pending.m_signed,
            scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K,
            distal=self.distal, pendant=self.pendant, log_eps=self.log_eps,
            k=self.k, B=self.B, keep_at_most=self.config.keep_at_most,
            keep_factor=self.config.keep_factor,
        )
