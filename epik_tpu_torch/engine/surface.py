"""``PlacerSurface``: the ``place``/``place_async``/``place_wait`` surface that
``engine/placer.py::TorchPlacer`` and ``parallel/sharding.py::ShardedTorchPlacer``
share, and the routing limits both read.

An engine stages a batch on its route (``_prepare_dense``/``_tiles``/``_csr``:
the route's name and ``launch``, which enqueues the device step and returns
the pending batch) and brings a step's result to the host (``_fetch``: one
(groups, rows, width) array). The surface dedups the batch, re-runs a step
while a static budget was too small (JAX placer.py:2720-2785, sharding.py:
1316-1387) and assembles the jplace rows. While the recorder of
``utils/spans.py`` is on, each part is a span (``place.stage``,
``place.launch``, ``place.sync``, ``place.retry``, ``place.assemble``) inside
the ``place`` span of ``run_pipeline``, which notes the batch's reads, its
distinct reads and its route.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core.alphabet import get_alphabet
from ..core.scoring import score_threshold
from ..utils import spans
from .config import PlacerConfig, check_supported
from .outputs import (
    _Pending,
    _SplitPending,
    assemble_arrays,
    merge_split,
    pack_totals,
    unpack_body,
    unpack_outputs_slim,
)
from .staging import HostStaging, _bucket, _bucket_lmax
from .types import PlacedCollection

__all__ = ["MAX_DIRECT_K", "MAX_PAIR_K", "MAX_READ_LEN", "MAX_TILE_PLEN", "PlacerSurface"]

#: the packed read format stores lengths as uint16
MAX_READ_LEN = 0xFFFF
#: largest k with a pair plane: the (k+1)-mer combo table is 4**(k+1) int32
MAX_PAIR_K = 12
#: largest k with a direct key -> row table (4**13 int32 = 268 MB)
MAX_DIRECT_K = 13
#: longest posting list the tiles take (placer.py:1844)
MAX_TILE_PLEN = 128


class PlacerSurface(HostStaging):
    """What both placers do alike. An engine sets ``_csr_floor``, the least
    bucket a retried per-read CSR budget rounds up to."""

    def __init__(self, db, tree, keep_at_most: int | None, keep_factor: float | None,
                 config: PlacerConfig | None):
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
        #: budget-overflow re-dispatches (the tiles' OV, the CSR steps' budgets)
        self.overflow_retries = 0
        self._retry_lock = threading.Lock()

    def _K(self) -> int:
        return min(self.config.keep_at_most, self.B)

    def _read_lengths(self, seqs):
        """The reads' lengths and their bucketed padded length (lens, Lmax),
        or None where the packed read format cannot take the batch: every
        read shorter than k, or a read longer than its uint16 length."""
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
        Lmax_true = int(lens_arr.max())
        if Lmax_true < self.k or Lmax_true > MAX_READ_LEN:
            return None
        return lens_arr, _bucket_lmax(Lmax_true)

    def _stage_bytes(self, seqs, R: int | None = None):
        """Host staging of the device-tokenizer dense steps (JAX
        placer.py:2478-2612): one packed uint8 buffer of R reads (the batch's
        own count by default), plus the host-tokenized ambiguity rows of the
        reads that hold IUPAC characters (quirks Q6/Q7).

        Returns (buf, arows, Amax, Lmax, m_signed), or None where JAX returns
        None (:meth:`_read_lengths`). Unlike the JAX version, one device does
        not pad R to a bucket: eager PyTorch has no compile cache."""
        gate = self._read_lengths(seqs)
        if gate is None:
            return None
        lens_arr, Lmax = gate
        R = len(seqs) if R is None else R
        buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R)
        arows, Amax = self._amb_rows(seqs, amb_mask, R)
        return buf, arows, Amax, Lmax, lens_arr - self.k + 1  # m for assembly (quirk Q1)

    def _note_batch(self, R: int) -> None:
        """An engine's own notes on the ``place`` span of a batch of R
        distinct reads, while the recorder is on."""

    def _prepare(self, sequence_map, seqs):
        """Stage a batch on the engine's route; a batch the tile step
        declines (None) goes to the CSR steps whole."""
        if self.route == "dense":
            return self._prepare_dense(sequence_map, seqs)
        if self.route == "tiles":
            prepared = self._prepare_tiles(sequence_map, seqs)
            if prepared is not None:
                return prepared
        return self._prepare_csr(sequence_map, seqs)

    # -- the place surface ----------------------------------------------------

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """Synchronous place (reference surface: place.cpp:201)."""
        return self.place_wait(self.place_async(records))

    def place_async(self, records: list[tuple[str, bytes]]):
        """Stage a batch and enqueue its device step without waiting for it."""
        with spans.span("place.stage"):
            # dedup by content (quirk Q8; reference: place.cpp:73-81,207)
            sequence_map: dict[bytes, list[str]] = {}
            for header, seq in records:
                sequence_map.setdefault(seq, []).append(header)
            seqs = list(sequence_map.keys())
            if not seqs:
                return _Pending(sequence_map, [], None, None, self._K())
            route, launch = self._prepare(sequence_map, seqs)
        spans.note("reads", len(records))
        spans.note("distinct", len(seqs))
        spans.note("route", route)
        if spans.enabled():
            self._note_batch(len(seqs))
        with spans.span("place.launch"):
            return launch()

    def _count_retry(self) -> None:
        with self._retry_lock:  # the pipeline waits on batches from several threads
            self.overflow_retries += 1

    def place_wait(self, pending):
        """Fetch a batch's result, re-running its step while a budget was too
        small, and assemble its jplace rows."""
        if isinstance(pending, _SplitPending):
            clean, amb = self.place_wait(pending.clean), self.place_wait(pending.amb)
            with spans.span("place.assemble"):
                return merge_split(pending, clean, amb)
        if pending.out is None:
            return PlacedCollection(sequence_map=pending.sequence_map, placed_seqs=[])
        K, seqs = pending.K, pending.seqs
        with spans.span("place.sync"):
            arr = self._fetch(pending.out, seqs)
        budget = pending.budget
        if budget is None:
            # the dense steps: the slim (R, 2K+3) pack or the classic plane's
            # full (R+1, 4K+2) one with its totals row, whose widths differ
            # for every K >= 1 (placer.py:2753-2758)
            body = arr if arr.shape[2] == 2 * K + 3 else arr[:, :-1]
        elif budget[0] == "tiles_ov":
            # the last column carries each read's true overflow-window count
            _, OV, rerun = budget
            while arr.size and int(arr[..., -1].max()) > OV:
                self._count_retry()
                OV = _bucket(int(arr[..., -1].max()), 8)  # rerun clamps to W
                with spans.span("place.retry"):
                    spans.note("budget", OV)
                    arr = self._fetch(rerun(OV), seqs)
            body = arr[..., :-1]
        else:
            # the last row carries the budget totals; a hot shard (skewed
            # posting lengths) overflows the uniform estimate
            _, P, PA, rerun = budget
            while True:
                e_total, a_total = pack_totals(arr)
                if e_total <= P and a_total <= PA:
                    break
                self._count_retry()
                P = _bucket(e_total, self._csr_floor) if e_total > P else P
                PA = _bucket(a_total, self.config.min_bucket) if a_total > PA else PA
                with spans.span("place.retry"):
                    spans.note("budget", P)
                    spans.note("budget_amb", PA)
                    arr = self._fetch(rerun(P, PA), seqs)
            body = arr[:, :-1]
        with spans.span("place.assemble"):
            flat = body.reshape(-1, body.shape[2])[:len(seqs)]
            unpack = unpack_outputs_slim if flat.shape[1] == 2 * K + 3 else unpack_body
            scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum = unpack(flat, K)[:6]
            return assemble_arrays(
                seqs, pending.sequence_map, pending.m_signed,
                scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K,
                distal=self.distal, pendant=self.pendant, log_eps=self.log_eps,
                k=self.k, B=self.B, keep_at_most=self.config.keep_at_most,
                keep_factor=self.config.keep_factor,
            )
