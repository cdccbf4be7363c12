"""The column-sharded placement finish, per model shard, in two launches.

A column-sharded step (``parallel/sharding.py``) leaves each model shard the
shifted sums Sp (R, bwl) of its own branch columns. The finish of
``epik_tpu/parallel/sharding.py::finish_scores_cols_shifted`` +
``_lwr_topk_cols`` (an XLA function there, no Pallas kernel) runs per shard
around a merge of per-read scalars:

* :func:`finish_cols_partial` -- per read, the shard's touched count ``n_s``,
  its largest corrected score ``max_s`` (-inf when nothing is touched) and its
  top ``Kl = min(K, bwl)`` candidates (ties to the lowest column, the slots
  past ``n_s`` holding -inf and the lowest untouched columns) with global
  column ids, as f32 (R, 2 Kl + 2) = ``[values Kl | ids Kl | n_s | max_s]``;
* :func:`finish_cols_expsum` -- per read, the sum over the shard's touched
  columns of ``10**(corrected - max_t)`` against the merged (global) ``max_t``.

The merge, the untouched term, ``log_sum`` and the last top-K over the
shards' candidates are torch ops of the caller (``parallel/sharding.py::
finish_scores_cols_shifted``). ``csrc/finish_cols.cu`` holds both kernels;
each wrapper runs its plain PyTorch version below on a CPU tensor and its
kernel on a CUDA tensor (or raises).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ._build import check, library
from .finish import MAX_K

__all__ = ["expsum_from_corrected", "finish_cols_expsum", "finish_cols_expsum_plain",
           "finish_cols_partial", "finish_cols_partial_plain", "finish_cols_smem",
           "partial_from_corrected", "shifted_corrected"]

_count_lock = threading.Lock()


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


def partial_from_corrected(corrected: torch.Tensor, touched: torch.Tensor, *, K: int,
                           col0: int) -> torch.Tensor:
    """The partial pack of one shard from its corrected scores (-inf where not
    touched): a stable descending sort gives the candidates (ties to the
    lowest column, as ``jax.lax.top_k``)."""
    Kl = min(K, corrected.shape[1])
    vals, idx = torch.sort(corrected, dim=1, descending=True, stable=True)
    f32 = torch.float32
    return torch.cat([vals[:, :Kl], (idx[:, :Kl] + col0).to(f32),
                      touched.sum(dim=1, dtype=torch.int32).to(f32)[:, None],
                      corrected.max(dim=1).values[:, None]], dim=1)


def expsum_from_corrected(corrected: torch.Tensor, touched: torch.Tensor,
                          max_t: torch.Tensor) -> torch.Tensor:
    """Each read's sum of ``10**(corrected - max_t)`` over the touched columns."""
    dev = corrected.device
    terms = torch.where(touched, torch.exp((corrected - max_t[:, None])
                                           * _f32(math.log(10.0), dev)), _f32(0.0, dev))
    return terms.sum(dim=1)


def finish_cols_partial_plain(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                              log_eps: float, col0: int) -> torch.Tensor:
    """Plain version of launch A, operation for operation the JAX column
    finish's per-shard half."""
    corrected, touched = shifted_corrected(Sp, m_f32, k=k, log_eps=log_eps)
    return partial_from_corrected(corrected, touched, K=K, col0=col0)


def finish_cols_expsum_plain(Sp: torch.Tensor, m_f32: torch.Tensor, max_t: torch.Tensor, *,
                             k: int, log_eps: float) -> torch.Tensor:
    """Plain version of launch B."""
    corrected, touched = shifted_corrected(Sp, m_f32, k=k, log_eps=log_eps)
    return expsum_from_corrected(corrected, touched, max_t)


def _check_vec(name: str, v: torch.Tensor, Sp: torch.Tensor) -> None:
    if v.dtype != torch.float32 or v.shape != (Sp.shape[0],) or not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 ({Sp.shape[0]},), got "
                         f"{v.dtype} {tuple(v.shape)}")
    if v.device != Sp.device:
        raise ValueError(f"Sp on {Sp.device} but {name} on {v.device}")


def _check_sp(Sp: torch.Tensor, m_f32: torch.Tensor) -> None:
    if Sp.dtype != torch.float32 or Sp.dim() != 2 or Sp.stride(1) != 1:
        raise ValueError(f"Sp must be 2-D float32 with contiguous rows, got "
                         f"{Sp.dtype} {tuple(Sp.shape)} strides {Sp.stride()}")
    _check_vec("m_f32", m_f32, Sp)
    if Sp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {Sp.device}")


def finish_cols_smem(Sp: torch.Tensor, K: int) -> tuple[int, int]:
    """(bytes of shared memory launch A asks at Sp's width and ``min(K,
    bwl)`` candidates, bytes a block of it may take on Sp's card), from the
    CUDA source's own formula: ceil(bwl / 32) mask words, bwl 16-bit ids up to
    bwl = 2**16 (past it the ids go to a global workspace) and the 16 warps'
    candidates, against the card's opt-in limit less the kernel's static
    bytes. CUDA tensors only."""
    bwl = Sp.shape[1]
    lib = library()
    with torch.cuda.device(Sp.device):
        need = lib.epik_finish_cols_smem(bwl, min(K, bwl))
        limit = lib.epik_finish_cols_smem_limit(bwl)
    if limit < 0:
        check(int(-limit), "finish_cols_partial")
    return need, limit


def finish_cols_partial(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                        log_eps: float, col0: int) -> torch.Tensor:
    """Sp f32 (R, bwl) one shard's shifted sums (rows may be strided), m_f32
    f32 (R,) window counts, ``col0`` the shard's first global column -> f32
    (R, 2 Kl + 2) with Kl = min(K, bwl).

    Limit: the mask's shared memory (:func:`finish_cols_smem`), bwl up to
    about 1.8 million columns; a wider shard raises ValueError."""
    _check_sp(Sp, m_f32)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} must lie in [1, {MAX_K}]")
    if col0 < 0:
        raise ValueError(f"col0={col0} must be >= 0")
    if Sp.device.type == "cpu":
        return finish_cols_partial_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps, col0=col0)
    R, bwl = Sp.shape
    Kl = min(K, bwl)
    out = torch.empty((R, 2 * Kl + 2), dtype=torch.float32, device=Sp.device)
    if R == 0:
        return out
    need, limit = finish_cols_smem(Sp, K)
    if need > limit:
        raise ValueError(f"finish_cols_partial: bwl={bwl} columns ask {need} bytes of shared "
                         f"memory, over the {limit} bytes a block may take on {Sp.device}")
    lib = library()
    layout = (ctypes.c_int * 3)()
    with torch.cuda.device(Sp.device):
        check(lib.epik_finish_cols_layout(R, bwl, Kl, layout), "finish_cols_partial")
        _, blocks, n_ws = layout
        ws = torch.empty(n_ws, dtype=torch.int32, device=Sp.device) if n_ws else None
        stream = torch.cuda.current_stream(Sp.device).cuda_stream
        err = lib.epik_finish_cols_partial(Sp.data_ptr(), Sp.stride(0), m_f32.data_ptr(),
                                           out.data_ptr(), R, bwl, Kl, col0, k, float(log_eps),
                                           ws.data_ptr() if ws is not None else None, blocks,
                                           stream)
    check(err, "finish_cols_partial")
    with _count_lock:
        finish_cols_partial.launches += 1
    return out


def finish_cols_expsum(Sp: torch.Tensor, m_f32: torch.Tensor, max_t: torch.Tensor, *, k: int,
                       log_eps: float) -> torch.Tensor:
    """Sp f32 (R, bwl) one shard's shifted sums (rows may be strided), m_f32
    f32 (R,), max_t f32 (R,) the merged maxima -> f32 (R,) sums of
    ``10**(corrected - max_t)`` over the shard's touched columns."""
    _check_sp(Sp, m_f32)
    _check_vec("max_t", max_t, Sp)
    if Sp.device.type == "cpu":
        return finish_cols_expsum_plain(Sp, m_f32, max_t, k=k, log_eps=log_eps)
    R, bwl = Sp.shape
    out = torch.empty((R,), dtype=torch.float32, device=Sp.device)
    if R == 0:
        return out
    lib = library()
    with torch.cuda.device(Sp.device):
        err = lib.epik_finish_cols_expsum(Sp.data_ptr(), Sp.stride(0), m_f32.data_ptr(),
                                          max_t.data_ptr(), out.data_ptr(), R, bwl, k,
                                          float(log_eps),
                                          torch.cuda.current_stream(Sp.device).cuda_stream)
    check(err, "finish_cols_expsum")
    with _count_lock:
        finish_cols_expsum.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
finish_cols_partial.launches = 0
finish_cols_expsum.launches = 0
