"""Kernel 2: the placement finish into the slim result pack.

``finish_topk(Sp, m_f32, K=, k=, log_eps=)`` computes what
``engine/placer.py::finish_scores_shifted`` + ``_lwr_topk`` +
``_pack_outputs_slim`` compute on the JAX main path, and what the fused finish
epilogue of the TPU kernel ``ops/pallas/accumulate.py::
segment_accumulate_packed_topk`` computes on the tiles path: per read,
``[scores K | idx K | log_sum | n | zero_sum]`` as float32 (R, 2K+3).

It runs after the segment sums on the f32-payload tile path; the dense path
runs the same finish fused into the row gather (``rowgather.rowgather_sum_topk``)
and the packed tile path fused into its accumulate. It reads the (R, B) score
matrix once and finishes over the touched branches only;
``csrc/finish_topk.cu`` and ``csrc/finish_row.cuh`` record the design and the
rounding rules that make its scores bit-equal to the plain version below.
"""

from __future__ import annotations

import math
import threading

import torch

from ._build import check, library

__all__ = ["MAX_K", "POW10_ZERO", "finish_topk", "finish_topk_plain", "lwr_topk_plain"]

#: largest K the finish takes (the tiles kernel's contract is K <= 62)
MAX_K = 64
#: exponent below which IEEE-double 10**x rounds to exactly 0.0 (quirk Q3)
POW10_ZERO = -323.6

_count_lock = threading.Lock()


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
    window counts -> f32 (R, 2K+3) slim pack."""
    _check_args(Sp, m_f32, K)
    if Sp.device.type == "cpu":
        return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)
    if Sp.device.type != "cuda":
        raise ValueError(f"finish_topk: no kernel for device {Sp.device}")
    R, B = Sp.shape
    if B > 1 << 16:  # 16-bit branch ids in shared memory
        raise ValueError(f"finish_topk: B={B} branches, over 2**16")
    out = torch.empty((R, 2 * K + 3), dtype=torch.float32, device=Sp.device)
    if R == 0:
        return out
    lib = library()
    with torch.cuda.device(Sp.device):
        stream = torch.cuda.current_stream(Sp.device).cuda_stream
        err = lib.epik_finish_topk(Sp.data_ptr(), Sp.stride(0), m_f32.data_ptr(),
                                   out.data_ptr(), R, B, K, k, float(log_eps),
                                   stream)
    check(err, "finish_topk")
    with _count_lock:
        finish_topk.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
finish_topk.launches = 0
