"""The column-sharded placement finish of one model shard, in one launch.

A column-sharded step (``parallel/sharding.py``) leaves each model shard the
sums of its own bwl branch columns. The per-shard half of
``epik_tpu/parallel/sharding.py::finish_scores_cols_shifted`` /
``finish_scores_cols`` + ``_lwr_topk_cols`` (an XLA function there, no Pallas
kernel) runs here, per read, into the shard's partial pack, f32 (R, 2 Kl + 3)
= ``[values Kl | global ids Kl | n_s | max_s | e_s]`` with Kl = min(K, bwl):

* ``n_s``, the shard's touched count; ``max_s``, its largest corrected score
  (-inf when nothing is touched); ``e_s``, the sum over its touched columns
  of ``10**(corrected - max_s)``, against the shard's OWN maximum (0 when
  nothing is touched);
* the shard's top Kl candidates, ties to the lowest column, the slots past
  ``n_s`` holding -inf and the lowest untouched columns, ids written as
  global columns (local + ``col0``).

:func:`finish_cols_partial` takes the shifted sums (touched: Sp > 0);
:func:`finish_cols_partial_counts` the classic sums and exact counts
(touched: C > 0, ``m - C`` wrapped to 2**64 where negative, quirk Q1) and
also returns the candidates' counts, int32 (R, Kl). The merge (the caller's
``parallel/sharding.py::_merge_cols``) rescales each ``e_s`` by
``10**(max_s - max_t)`` against the merged maximum. ``csrc/finish_cols.cu``
holds the kernel (both forms): one block a read, its touched columns'
corrected scores computed once into a shared-memory cache, the block sized
to the width (:func:`finish_cols_layout`); each wrapper runs its plain
PyTorch version below on a CPU tensor and the kernel on a CUDA tensor (or
raises). On the
dense shards the same finish runs in kernel 1's epilogue
(``rowgather.rowgather_sum_cols`` / ``rowgather_sum_counts_cols``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ._build import check, library
from .finish import MAX_K

__all__ = ["counts_corrected", "finish_cols_layout", "finish_cols_partial",
           "finish_cols_partial_counts", "finish_cols_partial_counts_plain",
           "finish_cols_partial_plain", "partial_from_corrected", "shifted_corrected"]

_count_lock = threading.Lock()
#: the wrapped size_t of the reference (quirk Q1)
_U64 = float(2**64)


def _f32(x: float, dev) -> torch.Tensor:
    """A 0-dim f32 tensor on ``dev``: PyTorch's CUDA ops with a CPU scalar
    divide by multiplying with the reciprocal, which rounds differently."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


def shifted_corrected(Sp: torch.Tensor, m_f32: torch.Tensor, *, k: int, log_eps: float):
    """(corrected, touched) of shifted sums: ``(Sp + m * log_eps) / k`` where
    ``Sp > 0``, else -inf."""
    dev = Sp.device
    touched = Sp > 0
    c = (Sp + m_f32[:, None] * _f32(log_eps, dev)) / _f32(float(k), dev)
    return torch.where(touched, c, _f32(-math.inf, dev)), touched


def counts_corrected(S: torch.Tensor, C: torch.Tensor, m_f32: torch.Tensor, *, k: int,
                     log_eps: float):
    """(corrected, touched) of classic sums and exact counts (JAX
    ``finish_scores_cols``): ``(S + diff * log_eps) / k`` where ``C > 0``,
    ``diff = m - C`` wrapped to 2**64 where negative (quirk Q1), else -inf."""
    dev = S.device
    touched = C > 0
    diff = m_f32[:, None] - C.to(torch.float32)
    diff = torch.where(diff < 0, _f32(_U64, dev), diff)
    c = (S + diff * _f32(log_eps, dev)) / _f32(float(k), dev)
    return torch.where(touched, c, _f32(-math.inf, dev)), touched


def partial_from_corrected(corrected: torch.Tensor, touched: torch.Tensor, *, K: int,
                           col0: int) -> torch.Tensor:
    """The partial pack of one shard from its corrected scores (-inf where not
    touched): a stable descending sort gives the candidates (ties to the
    lowest column, as ``jax.lax.top_k``); ``e_s`` is taken against the
    shard's own maximum."""
    dev = corrected.device
    Kl = min(K, corrected.shape[1])
    vals, idx = torch.sort(corrected, dim=1, descending=True, stable=True)
    max_s = corrected.max(dim=1).values
    terms = torch.where(touched, torch.exp((corrected - max_s[:, None])
                                           * _f32(math.log(10.0), dev)), _f32(0.0, dev))
    f32 = torch.float32
    return torch.cat([vals[:, :Kl], (idx[:, :Kl] + col0).to(f32),
                      touched.sum(dim=1, dtype=torch.int32).to(f32)[:, None],
                      max_s[:, None], terms.sum(dim=1)[:, None]], dim=1)


def finish_cols_partial_plain(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                              log_eps: float, col0: int) -> torch.Tensor:
    """Plain version of the shifted form, operation for operation the JAX
    column finish's per-shard half."""
    corrected, touched = shifted_corrected(Sp, m_f32, k=k, log_eps=log_eps)
    return partial_from_corrected(corrected, touched, K=K, col0=col0)


def finish_cols_partial_counts_plain(S: torch.Tensor, C: torch.Tensor, m_f32: torch.Tensor, *,
                                     K: int, k: int, log_eps: float, col0: int):
    """Plain version of the counts form: the pack and the candidates' counts
    (``C`` at each candidate's local column, as ``take_along_axis``)."""
    corrected, touched = counts_corrected(S, C, m_f32, k=k, log_eps=log_eps)
    pack = partial_from_corrected(corrected, touched, K=K, col0=col0)
    Kl = (pack.shape[1] - 3) // 2
    return pack, torch.gather(C, 1, pack[:, Kl:2 * Kl].long() - col0)


def _check_sums(S: torch.Tensor, m_f32: torch.Tensor, K: int, col0: int) -> None:
    if S.dtype != torch.float32 or S.dim() != 2 or S.stride(1) != 1:
        raise ValueError(f"the sums must be 2-D float32 with contiguous rows, got "
                         f"{S.dtype} {tuple(S.shape)} strides {S.stride()}")
    if (m_f32.dtype != torch.float32 or m_f32.shape != (S.shape[0],)
            or not m_f32.is_contiguous()):
        raise ValueError(f"m_f32 must be contiguous float32 ({S.shape[0]},), got "
                         f"{m_f32.dtype} {tuple(m_f32.shape)}")
    if m_f32.device != S.device:
        raise ValueError(f"sums on {S.device} but m_f32 on {m_f32.device}")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {S.device}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} must lie in [1, {MAX_K}]")
    if col0 < 0:
        raise ValueError(f"col0={col0} must be >= 0")


@functools.lru_cache(maxsize=None)
def _layout(device: torch.device, bwl: int, K: int, counts: bool) -> tuple:
    """The CUDA source's layout at (bwl, K) on ``device`` (it follows from the
    width and the card alone, so it is asked once): (global ids, threads,
    cache scores, shared memory, the limit, blocks an SM)."""
    out = (ctypes.c_int64 * 6)()
    with torch.cuda.device(device):
        check(library().epik_finish_cols_layout(bwl, K, int(counts), out), "finish_cols_partial")
    return tuple(out)


def finish_cols_layout(S: torch.Tensor, K: int, counts: bool = False) -> dict:
    """The launch layout at S's shape and ``min(K, bwl)`` candidates on S's
    card (``counts``: of the counts form), from the CUDA source's one layout
    formula: ``global_ids`` (past bwl = 2**16), ``threads`` a block (128 up
    to bwl = 4,096, else 512), ``blocks_per_sm`` (what the card gives the
    kernel as compiled), ``cache`` (the corrected scores a block keeps: what
    is left of an SM's shared memory at that occupancy, none where the rest
    fills it), ``smem`` (bytes a launch asks: ceil(bwl / 32) mask words, bwl
    16-bit ids up to bwl = 2**16, the warps' candidates and the cache),
    ``limit`` (bytes a block may take: the card's opt-in limit less the
    kernel's static bytes), ``blocks`` (R, or with global ids as many as the
    card holds at once, at most R) and ``workspace`` (the global ids' int32
    count). CUDA tensors only."""
    R, bwl = S.shape
    global_ids, threads, cache, smem, limit, per_sm = _layout(S.device, bwl, min(K, bwl), counts)
    on_card = per_sm * torch.cuda.get_device_properties(S.device).multi_processor_count
    blocks = min(R, on_card) if global_ids else R
    return {"global_ids": bool(global_ids), "threads": int(threads),
            "blocks_per_sm": int(per_sm), "cache": int(cache), "smem": int(smem),
            "limit": int(limit), "blocks": int(blocks),
            "workspace": int(blocks * bwl) if global_ids else 0}


def _launch(fn, S: torch.Tensor, C, m_f32: torch.Tensor, *, K: int, k: int, log_eps: float,
            col0: int):
    """The kernel on (S[, C]): (pack, counts or None)."""
    R, bwl = S.shape
    Kl = min(K, bwl)
    out = torch.empty((R, 2 * Kl + 3), dtype=torch.float32, device=S.device)
    cnt = None if C is None else torch.empty((R, Kl), dtype=torch.int32, device=S.device)
    if R == 0:
        return out, cnt
    lay = finish_cols_layout(S, K, counts=C is not None)
    if lay["smem"] > lay["limit"]:
        raise ValueError(f"{fn.__name__}: bwl={bwl} columns ask {lay['smem']} bytes of shared "
                         f"memory, over the {lay['limit']} bytes a block may take on {S.device}")
    ws = (torch.empty(lay["workspace"], dtype=torch.int32, device=S.device)
          if lay["workspace"] else None)
    with torch.cuda.device(S.device):
        err = library().epik_finish_cols_partial(
            S.data_ptr(), S.stride(0), C.data_ptr() if C is not None else None,
            C.stride(0) if C is not None else 0, m_f32.data_ptr(), out.data_ptr(),
            cnt.data_ptr() if cnt is not None else None, R, bwl, Kl, col0, k, float(log_eps),
            ws.data_ptr() if ws is not None else None, lay["blocks"], lay["cache"], lay["smem"],
            torch.cuda.current_stream(S.device).cuda_stream)
    check(err, fn.__name__)
    with _count_lock:
        fn.launches += 1
    return out, cnt


def finish_cols_partial(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                        log_eps: float, col0: int) -> torch.Tensor:
    """Sp f32 (R, bwl) one shard's shifted sums (rows may be strided), m_f32
    f32 (R,) window counts, ``col0`` the shard's first global column -> f32
    (R, 2 Kl + 3) partial pack with Kl = min(K, bwl).

    Limit: the mask's shared memory (:func:`finish_cols_layout`), bwl up to
    about 1.8 million columns; a wider shard raises ValueError."""
    _check_sums(Sp, m_f32, K, col0)
    if Sp.device.type == "cpu":
        return finish_cols_partial_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps, col0=col0)
    return _launch(finish_cols_partial, Sp, None, m_f32, K=K, k=k, log_eps=log_eps,
                   col0=col0)[0]


def finish_cols_partial_counts(S: torch.Tensor, C: torch.Tensor, m_f32: torch.Tensor, *,
                               K: int, k: int, log_eps: float, col0: int):
    """S f32 and C int32 (R, bwl) one shard's classic sums and exact counts
    (rows may be strided), m_f32 f32 (R,) window counts, ``col0`` the shard's
    first global column -> (f32 (R, 2 Kl + 3) partial pack, int32 (R, Kl) the
    candidates' counts). The limit as :func:`finish_cols_partial`'s."""
    _check_sums(S, m_f32, K, col0)
    if C.dtype != torch.int32 or C.shape != S.shape or C.stride(1) != 1:
        raise ValueError(f"C must be int32 {tuple(S.shape)} with contiguous rows, got "
                         f"{C.dtype} {tuple(C.shape)} strides {C.stride()}")
    if C.device != S.device:
        raise ValueError(f"S on {S.device} but C on {C.device}")
    if S.device.type == "cpu":
        return finish_cols_partial_counts_plain(S, C, m_f32, K=K, k=k, log_eps=log_eps,
                                                col0=col0)
    return _launch(finish_cols_partial_counts, S, C, m_f32, K=K, k=k, log_eps=log_eps,
                   col0=col0)


#: kernel launches since the last reset (CUDA only; the plain path never counts)
finish_cols_partial.launches = 0
finish_cols_partial_counts.launches = 0
