"""``TorchPlacer``: the placement engine of the port on PyTorch.

Ports ``epik_tpu.engine.placer.JaxPlacer`` for DNA and amino databases along
three routes, chosen at construction by the JAX package's rules
(placer.py:1796-2077) with the port's memory budgets:

* ``dense`` -- for a database whose dense plane fits the budget
  (``dense_db="auto"`` with ``accumulate="auto"``, or ``dense_db="on"``).
  JAX's flags pick the plane and the step: the shifted plane (f32, or int16
  with ``precision="int16"``) when the rows are resolved on the host
  (``lookup_where``) and every stored score is >= log10(eps), else the
  classic plane (f32, or bf16 with ``precision="bf16"``). On a DNA database
  with k <= 13 the device tokenizer (``tokenize_where``) runs over the pair
  plane when it is shifted f32, k <= 12 and it fits its budget
  (``place_batch_dense_paired``), else over the direct key -> row table
  (``place_batch_dense_bytes``). On the shifted plane of any other database
  (amino, DNA k >= 14) with sigma**k < 2**48, the codes tokenizer runs with
  the radix lookup (``place_batch_dense_codes``) when the radix index's
  largest bucket is at most 32 keys, over the codes pair plane with
  ``pair_plane="on"`` when it fits (``place_batch_dense_codes_paired``). A
  batch the device tokenizers cannot take (every read shorter than k, a read
  over 65,535 bp), and every batch without one, is tokenized on the host:
  plane rows found on the host (``place_batch_dense_rows``) or, with
  ``lookup_where="device"``, keys looked up in the cuckoo table on the device
  (``place_batch_device_densedb``). Where a shifted f32 plane's steps gather
  apart from #1 (past the width rule) and at most 1/32 of its cells are
  posted, the state also holds those cells (``state.posted_index``), which
  the gather reads instead of the plane's rows, with the finish fused in
  where its shared memory fits (``step.PostedGather``);
* ``tiles`` -- the big-tree posting-tile path (DNA, k <= 13), when the dense
  plane is not taken and the tiles fit: every clean batch runs the tile step
  (packed or f32 payload; with the packed payload, ``pair_plane="on"`` and
  k + 1 <= 13 the pair-fused tiles, when the database has a pair and they
  fit, ``place_batch_tiles_paired``); a batch holding IUPAC reads splits, its ambiguous reads going
  to the CSR step; a batch the tile step cannot take (reads too long for the
  packed payload's exact integer sums, every read shorter than k, a read over
  65,535 bp) goes to the CSR step whole;
* ``csr`` -- every batch through the CSR step (cuckoo lookup, per-read
  posting cells, segment accumulate with counts), when neither fits, and
  with ``accumulate="scatter"``, which takes neither the dense plane (unless
  ``dense_db="on"``) nor the tiles (JAX's tiles need its matmul accumulate):
  there the CSR step lays the batch's postings out flat over one budget
  (JAX's scatter engine, ``accumulate_exact``).

``place`` -> ``place_async`` (dedup, host staging, the device step) ->
``place_wait`` (one result transfer, budget retries, assembly) are the
surface it shares with the sharded placer (``surface.py::PlacerSurface``),
which opens the ``place.*`` spans; on the dense route the placer notes on
the ``place`` span the gather its steps run (``gather``), decided once at
construction (``step.py::dense_gather``), and, where the gather and the
finish run apart, the bytes of the sums between them (``sums_bytes``; none
where the finish is fused into the gather).

The device defaults to the card (``device="cuda"``), and the CPU runs only
when the caller names it; ``"cuda"`` without CUDA raises, so the placer never
carries on on the CPU. On a CUDA device every kernel of a step runs as
hand-written CUDA (``epik_tpu_torch/kernels``); on the CPU the kernels' plain
PyTorch versions run.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.accumulate_packed import MAX_PACKED_BRANCHES, tile_width
from ..kernels.rowgather import posted_fits
from ..ops.csr import ORDER_INF
from ..ops.radix_lookup import DeviceRadix, build_radix
from ..utils import spans
from .config import PlacerConfig, device_budget
from .outputs import _Pending, _SplitPending
from .staging import _bucket, key_matrix, pad_i32, pad_u64_split, wrapped_m
from .state import (
    CsrState,
    PlaneState,
    build_csr_state,
    build_plane_state,
    pair_tables,
    posted_index,
)
from .step import (
    PostedGather,
    dense_gather,
    place_batch_csr,
    place_batch_dense_bytes,
    place_batch_dense_codes,
    place_batch_dense_codes_paired,
    place_batch_dense_paired,
    place_batch_dense_rows,
    place_batch_device_densedb,
    place_batch_tiles_bytes,
    place_batch_tiles_paired,
    sums_bytes,
)
from .surface import MAX_DIRECT_K, MAX_PAIR_K, MAX_TILE_PLEN, PlacerSurface
from .tables import direct_table, enumerate_pairs_generic
from .tiles import Q_MAX, TileState, build_tile_state, tile_bytes

__all__ = ["TorchPlacer"]

#: keys the codes tokenizer builds: sigma**k < 2**48
_MAX_RADIX_KEY_BITS = 48
#: the radix lookup's largest bucket (probe count) the codes path takes
_MAX_RADIX_BUCKET = 32


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchPlacer(PlacerSurface):
    """Single-device placer with the reference's ``place(batch)`` surface.

    ``state``: a prebuilt :class:`~.state.PlaneState` (the dense route, e.g.
    from :func:`~.state.plane_state_from_numpy`) or
    :class:`~.tiles.TileState` (the tiles route, e.g. from
    :func:`~.tiles.tile_state_from_numpy`) instead of building it from
    ``db``. ``route`` is ``"dense"``, ``"tiles"`` or ``"csr"``."""

    def __init__(self, db, tree, keep_at_most: int | None = None,
                 keep_factor: float | None = None,
                 config: PlacerConfig | None = None, *, device="cuda",
                 state: PlaneState | TileState | None = None):
        self.device = _resolve_device(device)
        super().__init__(db, tree, keep_at_most, keep_factor, config)
        # a retried per-read budget is a multiple of 512, the flat one not
        # (placer.py:2777)
        self._csr_floor = (self.config.min_bucket if self.config.accumulate == "scatter"
                           else max(self.config.min_bucket, 512))
        lens = np.diff(db.row_off)
        self._avg_plen = float(lens.mean()) if lens.size else 1.0
        self._max_plen = int(lens.max()) if lens.size else 0
        self._csr_cache: CsrState | None = None
        self.state: PlaneState | None = None
        self.tiles: TileState | None = None
        # JAX's dense flags (placer.py:1807-1823, 1881-1890, 1942-2077), set
        # by _route for the dense route
        self._host_lookup = self._fast_bytes = self._shifted = self._plane_q = False
        self._paired = self._want_codes = self._fast_codes = self._paired_codes = False
        #: the dense steps' gather (``step.py::dense_gather``), set by _pick_gather
        self._gather = None
        self.route = self._route(state)

    # -- routing (placer.py:1796-2026) ---------------------------------------------

    def _route(self, state) -> str:
        cfg = self.config
        db = self.db
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
            self._pick_gather(dense_budget)
            return "dense"
        if (cfg.accumulate != "scatter" and shift_ok and self.alphabet.sigma == 4
                and self.k <= MAX_DIRECT_K and n_keys > 0
                and cfg.precision == "exact" and cfg.tokenize_where in ("auto", "device")
                and self._max_plen <= MAX_TILE_PLEN
                and tile_bytes(n_keys, self._max_plen) <= dense_budget):
            # the pair-fused tiles (placer.py:2087-2092); the build falls back
            # to the unpaired tiles without a pair or over the budget
            paired = packed and cfg.pair_plane == "on" and self.k + 1 <= MAX_DIRECT_K
            self.tiles = state if state is not None else build_tile_state(
                db, k=self.k, B=self.B, log_eps=self.log_eps, packed=packed,
                device=self.device, paired=paired, budget=dense_budget)
            return "tiles"
        return "csr"

    def _dense_flags(self, shift_ok: bool) -> None:
        """JAX's flags of the dense route (placer.py:1807-1823, 1881-1890,
        1942-1955): the host row lookup, the DNA device tokenizer, the shifted
        plane, the int16 plane, and whether the codes tokenizer is a
        candidate. The radix index's bucket gate and the pair planes' fit are
        decided when the state is built (:meth:`_build_state`)."""
        cfg = self.config
        sigma = self.alphabet.sigma
        self._host_lookup = cfg.lookup_where in ("auto", "host")
        self._fast_bytes = (cfg.tokenize_where in ("auto", "device") and sigma == 4
                            and self.k <= MAX_DIRECT_K)
        # the device-cuckoo dense path stays classic; int16 is shifted-only
        self._shifted = ((cfg.plane_mode == "shifted" or cfg.precision == "int16")
                         and cfg.precision in ("exact", "int16")
                         and self._host_lookup and shift_ok)
        self._plane_q = self._shifted and cfg.precision == "int16"
        self._want_codes = (self._shifted and not self._fast_bytes
                            and cfg.tokenize_where in ("auto", "device")
                            and self.db.num_kmers > 0
                            and sigma ** self.k < 1 << _MAX_RADIX_KEY_BITS)

    def _radix(self, keys: np.ndarray, key_space: int) -> DeviceRadix | None:
        """The radix index over sorted ``keys`` (< ``key_space``) on the
        device, or None where JAX takes the host route: keys too wide for the
        index, or a bucket of more than 32 keys (a skewed key set)."""
        try:
            idx = build_radix(keys, int(key_space - 1).bit_length())
        except ValueError:
            return None
        if not 0 < idx.max_bucket <= _MAX_RADIX_BUCKET:
            return None
        return DeviceRadix.from_index(idx, self.device)

    def _build_state(self, budget: int) -> PlaneState:
        """The plane of the dense flags: the pair plane when JAX builds it
        (placer.py:1973-2026) and it fits ``pair_plane_budget`` (or the
        device's budget), else the unpaired plane with the direct table for
        the device tokenizer; on the codes path the radix index, and with
        ``pair_plane="on"`` the codes pair plane when it fits (placer.py:
        2027-2077)."""
        cfg = self.config
        kw = dict(k=self.k, B=self.B, log_eps=self.log_eps, shifted=self._shifted,
                  precision=cfg.precision, device=self.device)
        if self._want_codes:
            return self._build_codes_state(budget, kw)
        if (self._fast_bytes and self._shifted and not self._plane_q
                and cfg.pair_plane in ("auto", "on") and self.k <= MAX_PAIR_K
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

    def _build_codes_state(self, budget: int, kw: dict) -> PlaneState:
        """The codes path's plane: the radix index over the keys (None: the
        host route), and with ``pair_plane="on"`` on the f32 plane the pair
        rows and the pair radix index when the pair plane fits its budget
        and its index takes the gate; else the unpaired plane."""
        cfg, db = self.config, self.db
        sigma, n_keys = self.alphabet.sigma, db.num_kmers
        radix = self._radix(db.keys, sigma ** self.k)
        if (radix is not None and not self._plane_q and cfg.pair_plane == "on"
                and sigma ** (self.k + 1) < 1 << _MAX_RADIX_KEY_BITS):
            pu, pv, key11 = enumerate_pairs_generic(db.keys, self.k, sigma)
            n_pairs = int(pu.shape[0])
            plane_w = -(-self.B // 128) * 128
            paired_bytes = (n_keys + 1 + n_pairs) * plane_w * 4
            pair_budget = budget if cfg.pair_plane_budget is None else cfg.pair_plane_budget
            if n_pairs > 0 and paired_bytes <= pair_budget:
                pair_radix = self._radix(key11, sigma ** (self.k + 1))
                if pair_radix is not None:
                    return build_plane_state(db, pairs=(pu, pv, None), radix=radix,
                                             pair_radix=pair_radix, **kw)
        return build_plane_state(db, radix=radix, **kw)

    def _check_state(self) -> None:
        """A state handed in must be the plane the flags choose; its radix
        indexes set the codes path's flags."""
        st = self.state
        want = (torch.int16 if self._plane_q else torch.bfloat16
                if self.config.precision == "bf16" else torch.float32)
        self._paired = st.combo is not None
        self._fast_codes = st.radix is not None
        self._paired_codes = st.pair_radix is not None
        if (st.plane.dtype != want or (self._paired and not (self._fast_bytes
                                                              and self._shifted))
                or (self._fast_bytes and not self._paired and st.direct is None)
                or (self._fast_codes and not self._want_codes)
                or (self._paired_codes and not (self._fast_codes and st.n_pairs > 0))):
            raise ValueError(
                f"the dense state ({st.plane.dtype} plane, "
                f"{'pair' if self._paired or self._paired_codes else 'unpaired'}, radix "
                f"{self._fast_codes}) is not the plane of this config ({want}, shifted="
                f"{self._shifted}, device tokenizer={self._fast_bytes}, codes tokenizer="
                f"{self._want_codes})")

    def _pick_gather(self, budget: int) -> None:
        """The dense steps' gather, decided once (:func:`~.step.dense_gather`).
        Where it runs apart from #1 on a shifted f32 plane whose width the
        posted gather takes (``posted_fits``) and the plane is sparse enough,
        the state gets the plane's posted cells within ``budget`` beside it
        (:func:`~.state.posted_index`), which the gather then reads (a
        :class:`~.step.PostedGather`, the finish fused in where it fits);
        else the gather apart reads the plane's rows (1d)."""
        st = self.state
        self._gather = dense_gather(st.plane, self.B, self._K(), shifted=self._shifted,
                                    posted=st.posted)
        if (self._gather == "rows" and self._shifted and st.plane.dtype == torch.float32
                and posted_fits(st.plane.shape[1], st.plane.device)):
            posted = posted_index(st.plane, budget=budget - st.nbytes)
            if posted is not None:
                self.state = dataclasses.replace(st, posted=posted)
                self._gather = dense_gather(st.plane, self.B, self._K(), shifted=True,
                                            posted=posted)

    def posted_line(self) -> str:
        """The posted index's size, for the CLI's engine line ("" without
        one): its cells, its bytes and the share of the plane's cells."""
        st = self.state
        if st is None or st.posted is None:
            return ""
        p = st.posted
        return (f", posted cells {p.nnz:,} ({p.nbytes / 2**20:.1f} MiB, "
                f"{100.0 * p.nnz / st.plane.numel():.3f}% of the plane)")

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

    # -- the engine's part of the place surface --------------------------------

    def _note_batch(self, R: int) -> None:
        """On the dense route, note which gather its steps run (``gather``:
        ``fused``; ``posted_fused``, the posted gather with the finish fused
        in; ``pair`` for the gather and the finish apart, ``posted`` where
        the gather apart reads the plane's posted cells) and, apart, the
        bytes of the (R, bw) sums it writes and reads back (``sums_bytes``)."""
        if self.route != "dense":
            return
        gather = self._gather
        if isinstance(gather, PostedGather):
            note = gather.note
        else:
            note = "pair" if gather == "rows" else "fused"
        spans.note("gather", note)
        if note in ("pair", "posted"):
            spans.note("sums_bytes", sums_bytes(self.state.plane, R, shifted=self._shifted))

    def _fetch(self, out: torch.Tensor, seqs) -> np.ndarray:
        """A step's result on the host, as one group."""
        return out.cpu().numpy()[None]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A staged host array on the device, its bytes counted (``h2d_bytes``)."""
        spans.add("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def _prepare_dense(self, sequence_map, seqs):
        """The dense route: the device tokenizer's step where it takes the
        batch, else the host tokenizer's (``dense.host``)."""
        prepared = (self._prepare_device(sequence_map, seqs)
                    if self._fast_bytes or self._fast_codes else None)
        return prepared or self._prepare_dense_host(sequence_map, seqs)

    def _prepare_device(self, sequence_map, seqs):
        """The device-tokenizer dense steps: on a DNA database (JAX
        ``_place_async_bytes``, placer.py:2447-2476, 2575-2612) over the pair
        plane, or the unpaired plane through the direct table
        (``dense.bytes``); else the codes steps (JAX ``_place_async_codes``,
        placer.py:2614-2621) over the unpaired plane, or the codes pair plane
        (``dense.codes``). None for a batch the device tokenizer cannot
        take."""
        staged = (self._stage_bytes if self._fast_bytes else self._stage_codes)(seqs)
        if staged is None:
            return None
        buf, arows, Amax, Lmax, m_signed = staged
        st = self.state
        args = (self._to_device(buf), self._to_device(arows))
        kw = dict(B=self.B, K=self._K(), Amax=Amax, k=self.k, Lmax=Lmax,
                  num_kmers=st.n_keys, log_eps=float(self.log_eps), eps=float(self.eps),
                  gather=self._gather)
        sigma = self.alphabet.sigma
        if self._paired:
            step = functools.partial(place_batch_dense_paired, st.plane, st.combo, *args, **kw)
        elif self._fast_bytes:
            step = functools.partial(place_batch_dense_bytes, st.plane, st.direct, *args,
                                     shifted=self._shifted, plane_scale=st.scale, **kw)
        elif self._paired_codes:
            step = functools.partial(place_batch_dense_codes_paired, st.plane, st.radix,
                                     st.pair_radix, *args, sigma=sigma, n_pairs=st.n_pairs, **kw)
        else:
            step = functools.partial(place_batch_dense_codes, st.plane, st.radix, *args,
                                     sigma=sigma, plane_scale=st.scale, **kw)
        route = "dense.bytes" if self._fast_bytes else "dense.codes"
        return route, lambda: _Pending(sequence_map, seqs, m_signed, step(), self._K())

    def _stage_codes(self, seqs):
        """Host staging of the codes steps (JAX ``_stage_codes``, placer.py:
        2623-2690): one (R, Lmax + 2) uint8 buffer of alphabet codes and a
        trailing uint16 length per read, plus the host-tokenized ambiguity
        rows of the reads that hold an ambiguity code (quirks Q6/Q7).

        Returns (buf, arows, Amax, Lmax, m_signed), or None where JAX returns
        None (every read shorter than k, or a read longer than the uint16
        length). R is not padded."""
        gate = self._read_lengths(seqs)
        if gate is None:
            return None
        lens_arr, Lmax = gate
        R = len(seqs)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens_arr)])
        buf = np.zeros((R, Lmax + 2), np.uint8)
        buf[np.repeat(np.arange(R), lens_arr),
            np.arange(flat.size) - np.repeat(starts[:-1], lens_arr)] = flat
        # padding bytes (0) map to the invalid code
        buf[:, :Lmax] = self.alphabet.char_code[buf[:, :Lmax]]
        codes = buf[:, :Lmax]
        amb_mask = ((codes >= 0x80) & (codes != 0xFF)).any(axis=1)
        buf[:, Lmax] = lens_arr & 0xFF
        buf[:, Lmax + 1] = lens_arr >> 8
        arows, Amax = self._amb_rows(seqs, amb_mask, R)
        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        return buf, arows, Amax, Lmax, m_signed

    def _prepare_dense_host(self, sequence_map, seqs):
        """The dense branch of JAX ``_place_async_classic`` (placer.py:2369-2420):
        the host tokenizer, then the window and ambiguous keys of each read in
        processing order, as plane rows found on the host
        (``place_batch_dense_rows``) or, with ``lookup_where="device"``, as
        keys the device looks up (``place_batch_device_densedb``). A read
        shorter than k keeps no window and takes the Q1-wrapped m."""
        R = len(seqs)
        tokens = self._tokenize(seqs)
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        m_f32 = self._to_device(wrapped_m(m_signed))
        wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if tokens.exact_read.size else 1
        apr = int(np.bincount(tokens.amb_read, minlength=R).max()) if tokens.amb_read.size else 1
        # JAX pads the window columns to a multiple of 16 (its jit cache);
        # extra zero-row slots add nothing to a sum
        Wmax = max(1, wpr)
        st = self.state
        kw = dict(B=self.B, K=self._K(), k=self.k, log_eps=float(self.log_eps),
                  eps=float(self.eps), gather=self._gather)
        if self._host_lookup:
            Amax = _bucket(apr, 8) if tokens.amb_keys.size else 0
            rows = self._rows_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            arows = self._rows_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            step = functools.partial(
                place_batch_dense_rows, st.plane, self._to_device(rows), self._to_device(arows),
                m_f32, Amax=Amax, zero_row=st.n_keys, shifted=self._shifted,
                plane_scale=st.scale, **kw)
        else:
            Amax = _bucket(apr, 8)
            e_hi, e_lo = key_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            a_hi, a_lo = key_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            cs = self.csr
            step = functools.partial(
                place_batch_device_densedb, cs.table, cs.seed1, cs.seed2, st.plane,
                *(self._to_device(a.astype(np.int64)) for a in (e_hi, e_lo, a_hi, a_lo)),
                m_f32, zero_row=st.n_keys, **kw)
        return "dense.host", lambda: _Pending(sequence_map, seqs, m_signed, step(), self._K())

    def _prepare_tiles(self, sequence_map, seqs):
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
            clean = self._prepare_tiles({s: sequence_map[s] for s in seqs_c}, seqs_c)
            if clean is None:  # every clean read shorter than k
                return None
            amb = self._prepare_csr({s: sequence_map[s] for s in seqs_a}, seqs_a)
            return "tiles+csr", lambda: _SplitPending(sequence_map, seqs, idx_c, idx_a,
                                                      clean[1](), amb[1]())
        step, OV, m_signed = staged
        budget = None if OV is None else ("tiles_ov", OV, step)
        return "tiles", lambda: _Pending(sequence_map, seqs, m_signed, step(OV), self._K(),
                                         budget)

    def _stage_tiles(self, seqs):
        """The tiles branch of JAX ``_stage_bytes`` (placer.py:2478-2574).

        Returns None when the batch cannot take the tile step, ``("amb_split",
        amb_mask)`` when it holds IUPAC reads, else ``(step, OV, m_signed)``:
        ``step(OV)`` enqueues the device step with the two-level overflow
        budget OV (None, and ignored, without the two-level split)."""
        gate = self._read_lengths(seqs)
        if gate is None:
            return None
        lens_arr, Lmax = gate
        R = len(seqs)
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
        if ts.paired:
            step = functools.partial(
                place_batch_tiles_paired, ts.tiles, ts.direct, ts.direct11,
                self._to_device(buf), B=self.B, K=self._K(), k=self.k,
                Lmax=Lmax, num_kmers=ts.n_keys, PT=ts.pt, log_eps=float(self.log_eps),
                scale=ts.scale)
            return (lambda _ov: step()), None, m_signed
        step = functools.partial(
            place_batch_tiles_bytes, ts.tiles, ts.direct,
            self._to_device(buf), ts.tiles_ov,
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

    def _prepare_csr(self, sequence_map, seqs):
        step, P, PA, m_signed = self._stage_csr(seqs)
        return "csr", lambda: _Pending(sequence_map, seqs, m_signed, step(P, PA), self._K(),
                                       ("csr", P, PA, step))

    def _stage_csr(self, seqs):
        """The CSR branch of JAX ``_place_async_classic`` (placer.py:2369-2445):
        the kernel-backed engine's per-read posting budget P, or with
        ``accumulate="scatter"`` the scatter engine's flat budget P over the
        batch's postings (:2436).

        Returns ``(step, P, PA, m_signed)``: ``step(P, PA)`` enqueues the
        device step with those posting budgets."""
        cfg = self.config
        R = len(seqs)
        tokens = self._tokenize(seqs)
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        m_f32 = wrapped_m(m_signed)
        n_e = tokens.exact_keys.shape[0]
        n_a = tokens.amb_keys.shape[0]
        E = _bucket(n_e, cfg.min_bucket)
        A = _bucket(n_a, cfg.min_bucket)
        est = max(1, int(self._avg_plen * cfg.budget_headroom))
        flat = cfg.accumulate == "scatter"
        if flat:
            P = _bucket(n_e * est, cfg.min_bucket)
        else:
            wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if n_e else 1
            P = _bucket(wpr * est, max(cfg.min_bucket, 512))
        PA = _bucket(n_a * est, cfg.min_bucket)

        def dev(a: np.ndarray) -> torch.Tensor:
            return self._to_device(a.astype(np.int64))

        e_hi, e_lo = pad_u64_split(tokens.exact_keys, E)
        a_hi, a_lo = pad_u64_split(tokens.amb_keys, A)
        cs = self.csr
        step = functools.partial(
            place_batch_csr, cs.table, cs.seed1, cs.seed2, cs.post_b, cs.post_s,
            cs.row_off, dev(e_hi), dev(e_lo), dev(pad_i32(tokens.exact_read, E, R)),
            dev(a_hi), dev(a_lo), dev(pad_i32(tokens.amb_read, A, R)),
            dev(pad_i32(tokens.amb_order, A, ORDER_INF)),
            self._to_device(m_f32),
            R=R, B=self.B, K=self._K(), k=self.k, log_eps=float(self.log_eps),
            eps=float(self.eps), flat=flat)
        return (lambda p, pa: step(P=p, PA=pa)), P, PA, m_signed
