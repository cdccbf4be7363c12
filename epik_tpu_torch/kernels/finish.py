"""Kernel 2: the placement finish into the slim result pack, and the counts
finish into the full or the slim pack.

``finish_topk(Sp, m_f32, K=, k=, log_eps=)`` computes what
``engine/placer.py::finish_scores_shifted`` + ``_lwr_topk`` +
``_pack_outputs_slim`` compute on the JAX main path, and what the fused finish
epilogue of the TPU kernel ``ops/pallas/accumulate.py::
segment_accumulate_packed_topk`` computes on the tiles path: per read,
``[scores K | idx K | log_sum | n | zero_sum]`` as float32 (R, 2K+3).

It runs after the segment sums on the f32-payload tile path, and after the
row sums on the dense steps of trees past the fused kernel's shared-memory
limit; the dense path runs the same finish fused into the row gather
(``rowgather.rowgather_sum_topk``) and the packed tile path fused into its
accumulate. It reads the (R, B) score
matrix once and finishes over the touched branches only;
``csrc/finish_topk.cu`` and ``csrc/finish_row.cuh`` record the design and the
rounding rules that make its scores bit-equal to the plain version below.

``finish_topk_counts(S, C, m_f32, K=, k=, log_eps=, full=)`` is the same
kernel over the sums and exact counts of the classic plane and the CSR steps
(``engine/placer.py::finish_scores`` + ``_lwr_topk``: touched where C > 0, the
correction ``(S + (m - C) * log_eps) / k`` with ``m - C`` wrapped to 2**64
where negative, quirk Q1), into the full pack's body (R, 4K+2) ``[scores K |
wr K | idx K | counts K | n | zero_sum]`` (``_pack_outputs``) or the slim (R,
2K+3) pack (``_pack_outputs_slim``, the hash-sharded CSR steps).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ._build import check, library

__all__ = ["MAX_K", "POW10_ZERO", "finish_topk", "finish_topk_counts",
           "finish_topk_counts_plain", "finish_topk_plain", "lwr_topk_plain"]

#: largest K the finish takes (the tiles kernel's contract is K <= 62)
MAX_K = 64
#: exponent below which IEEE-double 10**x rounds to exactly 0.0 (quirk Q3)
POW10_ZERO = -323.6

_count_lock = threading.Lock()
#: the kernel variants of epik_finish_topk_layout
_SUMS_SLIM, _COUNTS_SLIM, _COUNTS_FULL = 0, 1, 2


def lwr_topk_plain(corrected: torch.Tensor, touched: torch.Tensor,
                   m_f32: torch.Tensor, *, K: int, k: int, log_eps: float):
    """LWR over all B branches and the top-K of ``corrected`` (-inf where not
    ``touched``): ``engine/placer.py::_lwr_topk`` without the counts.

    Returns (scores (R, K), idx (R, K) int64, n (R,) int32, log_sum (R,),
    zero_sum (R,) bool). Top-K is a stable descending sort: ties go to the
    lowest branch index, as with ``jax.lax.top_k`` (``torch.topk`` does not
    promise that)."""
    dev = corrected.device
    f32 = torch.float32
    B = corrected.shape[1]
    log_eps_t = torch.tensor(log_eps, dtype=f32, device=dev)
    k_t = torch.tensor(float(k), dtype=f32, device=dev)
    ln10 = torch.tensor(math.log(10.0), dtype=f32, device=dev)
    neg_inf = torch.tensor(-math.inf, dtype=f32, device=dev)
    m = m_f32.to(f32)
    # ---- LWR over ALL branches (quirk Q4) ------------------------------------
    n = touched.sum(dim=1, dtype=torch.int32)
    npl_exp = m * log_eps_t / k_t
    n_not = float(B) - n.to(f32)
    max_c = corrected.max(dim=1).values
    max_t = torch.maximum(max_c, torch.where(n_not > 0, npl_exp, neg_inf))
    terms = torch.where(touched, torch.exp((corrected - max_t[:, None]) * ln10),
                        torch.zeros((), dtype=f32, device=dev))
    sum10 = terms.sum(dim=1) + n_not * torch.exp(
        torch.where(n_not > 0, (npl_exp - max_t) * ln10, neg_inf))
    log_sum = max_t + torch.log(sum10) / ln10
    # quirk Q3: the reference's double pow underflows to exact 0
    zero_sum = (max_c < POW10_ZERO) & ((npl_exp < POW10_ZERO) | (n_not <= 0))
    # ---- top-K -----------------------------------------------------------------
    vals, idx = torch.sort(corrected, dim=1, descending=True, stable=True)
    return vals[:, :K], idx[:, :K], n, log_sum, zero_sum


def finish_topk_plain(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                      log_eps: float) -> torch.Tensor:
    """Plain version, operation for operation the JAX finish.

    Divisions use a 0-dim tensor on the same device: PyTorch's CUDA divide by
    a CPU scalar multiplies by the reciprocal, which rounds differently."""
    dev = Sp.device
    f32 = torch.float32
    log_eps_t = torch.tensor(log_eps, dtype=f32, device=dev)
    k_t = torch.tensor(float(k), dtype=f32, device=dev)
    neg_inf = torch.tensor(-math.inf, dtype=f32, device=dev)
    m = m_f32.to(f32)
    touched = Sp > 0
    corrected = torch.where(touched, (Sp + m[:, None] * log_eps_t) / k_t, neg_inf)
    vals, idx, n, log_sum, zero_sum = lwr_topk_plain(corrected, touched, m, K=K, k=k,
                                                     log_eps=log_eps)
    return torch.cat([vals, idx.to(f32), log_sum[:, None],
                      n.to(f32)[:, None], zero_sum.to(f32)[:, None]], dim=1)


def finish_topk_counts_plain(S: torch.Tensor, C: torch.Tensor, m_f32: torch.Tensor, *,
                             K: int, k: int, log_eps: float,
                             full: bool = True) -> torch.Tensor:
    """Plain version: ``ops/csr.py::finish_scores`` (the JAX ``finish_scores``
    operation for operation), then the body of ``pack_outputs`` (``full``) or
    the slim pack of the sharded CSR steps."""
    from ..ops.csr import finish_scores  # ops.csr imports this module

    scores, idx, counts, wr, n, zero_sum, log_sum = finish_scores(S, C, m_f32, K=K, k=k,
                                                                  log_eps=log_eps)
    f32 = torch.float32
    if full:
        cols = [scores, wr, idx.to(f32), counts.to(f32), n.to(f32)[:, None],
                zero_sum.to(f32)[:, None]]
    else:
        cols = [scores, idx.to(f32), log_sum[:, None], n.to(f32)[:, None],
                zero_sum.to(f32)[:, None]]
    return torch.cat(cols, dim=1)


def _check_args(Sp: torch.Tensor, m_f32: torch.Tensor, K: int) -> None:
    if Sp.dtype != torch.float32 or Sp.dim() != 2 or Sp.stride(1) != 1:
        raise ValueError(f"Sp must be 2-D float32 with contiguous rows, got "
                         f"{Sp.dtype} {tuple(Sp.shape)} strides {Sp.stride()}")
    if (m_f32.dtype != torch.float32 or m_f32.shape != (Sp.shape[0],)
            or not m_f32.is_contiguous()):
        raise ValueError(f"m_f32 must be contiguous float32 ({Sp.shape[0]},), "
                         f"got {m_f32.dtype} {tuple(m_f32.shape)}")
    if Sp.device != m_f32.device:
        raise ValueError(f"Sp on {Sp.device} but m_f32 on {m_f32.device}")
    if not 1 <= K <= min(MAX_K, Sp.shape[1]):
        raise ValueError(f"K={K} must lie in [1, min({MAX_K}, B={Sp.shape[1]})]")


def finish_topk(Sp: torch.Tensor, m_f32: torch.Tensor, *, K: int, k: int,
                log_eps: float) -> torch.Tensor:
    """Sp f32 (R, B) shifted row sums (rows may be strided), m_f32 f32 (R,)
    window counts -> f32 (R, 2K+3) slim pack.

    Limit: up to B = 2**16 a block keeps the touched ids in shared memory;
    past it they go to an int32 workspace allocated here, as many rows of B
    as blocks fit on the card at once, and only the ceil(B / 32) mask words,
    the candidates and the cached scores stay in shared memory (B up to
    about 1.5 million: a B whose mask does not fit raises ValueError)."""
    _check_args(Sp, m_f32, K)
    if Sp.device.type == "cpu":
        return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)
    if Sp.device.type != "cuda":
        raise ValueError(f"finish_topk: no kernel for device {Sp.device}")
    out = _launch(Sp, None, m_f32, K=K, k=k, log_eps=log_eps, variant=_SUMS_SLIM)
    with _count_lock:
        finish_topk.launches += 1
    return out


def _launch(S: torch.Tensor, C, m_f32: torch.Tensor, *, K: int, k: int, log_eps: float,
            variant: int) -> torch.Tensor:
    """One launch of the finish kernel's ``variant`` on the sums' card."""
    name = "finish_topk_counts" if C is not None else "finish_topk"
    R, B = S.shape
    width = 4 * K + 2 if variant == _COUNTS_FULL else 2 * K + 3
    out = torch.empty((R, width), dtype=torch.float32, device=S.device)
    if R == 0:
        return out
    lib = library()
    layout = (ctypes.c_int * 3)()
    with torch.cuda.device(S.device):
        if lib.epik_finish_topk_layout(R, B, K, variant, layout) != 0:
            raise ValueError(f"{name}: B={B} branches, past what the shared memory "
                             f"of the block's {(B + 31) // 32} mask words holds")
        _, blocks, n_ws = layout
        ws = torch.empty(n_ws, dtype=torch.int32, device=S.device) if n_ws else None
        stream = torch.cuda.current_stream(S.device).cuda_stream
        ws_ptr = ws.data_ptr() if ws is not None else None
        if C is None:
            err = lib.epik_finish_topk(S.data_ptr(), S.stride(0), m_f32.data_ptr(),
                                       out.data_ptr(), R, B, K, k, float(log_eps), ws_ptr,
                                       blocks, stream)
        else:
            err = lib.epik_finish_topk_counts(
                S.data_ptr(), S.stride(0), C.data_ptr(), C.stride(0), m_f32.data_ptr(),
                out.data_ptr(), R, B, K, k, float(log_eps), int(variant == _COUNTS_FULL),
                ws_ptr, blocks, stream)
    check(err, name)
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
finish_topk.launches = 0


def finish_topk_counts(S: torch.Tensor, C: torch.Tensor, m_f32: torch.Tensor, *, K: int,
                       k: int, log_eps: float, full: bool = True) -> torch.Tensor:
    """S f32 (R, B) sums and C int32 (R, B) exact counts (rows may be strided),
    m_f32 f32 (R,) window counts -> f32 (R, 4K+2) full pack body (``full``) or
    (R, 2K+3) slim pack.

    Limit: as :func:`finish_topk` (ids in a global workspace past B = 2**16)."""
    _check_args(S, m_f32, K)
    if (C.dtype != torch.int32 or C.shape != S.shape or C.stride(1) != 1
            or C.device != S.device):
        raise ValueError(f"C must be int32 {tuple(S.shape)} with contiguous rows on "
                         f"{S.device}, got {C.dtype} {tuple(C.shape)} strides {C.stride()} "
                         f"on {C.device}")
    if S.device.type == "cpu":
        return finish_topk_counts_plain(S, C, m_f32, K=K, k=k, log_eps=log_eps, full=full)
    if S.device.type != "cuda":
        raise ValueError(f"finish_topk_counts: no kernel for device {S.device}")
    out = _launch(S, C, m_f32, K=K, k=k, log_eps=log_eps,
                  variant=_COUNTS_FULL if full else _COUNTS_SLIM)
    with _count_lock:
        finish_topk_counts.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
finish_topk_counts.launches = 0
