"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* :func:`rowgather.rowgather_sum` -- kernel 1, the row gather + sum (f32 or
  int16 plane); :func:`rowgather.rowgather_sum_counts` and
  :func:`rowgather.rowgather_sum_counts_bf16`, the same with exact counts over
  the classic plane (f32 or bf16); :func:`rowgather.rowgather_sum_topk` and
  :func:`rowgather.rowgather_sum_topk_int16`, the gather with the ambiguous
  delta rows and the finish fused in (the dense shifted steps);
  :func:`rowgather.rowgather_sum_counts_topk` and
  :func:`rowgather.rowgather_sum_counts_topk_bf16`, the sums with counts,
  the ambiguous first hit and the counts finish fused in (the classic dense
  steps); :func:`rowgather.rowgather_sum_cols` and
  :func:`rowgather.rowgather_sum_counts_cols`, one column shard's sums (shifted,
  or classic with counts), the ambiguous first hit and the shard's column
  finish fused in (the column-sharded dense steps);
* :func:`finish.finish_topk` -- kernel 2, correction + LWR + top-K + pack;
  :func:`finish.finish_topk_counts`, the same over sums and exact counts
  (the CSR steps, and the classic steps past the fused kernel's limit);
* :func:`finish_cols.finish_cols_partial` and
  :func:`finish_cols.finish_cols_partial_counts` -- the column-sharded finish
  of one model shard in one launch (its touched count, maximum, sum of
  exponentials against that maximum and top-K candidates; the counts form
  over the classic sums and counts);
* :func:`accumulate_packed.accumulate_packed_topk` -- kernel 3, the packed
  posting-tile accumulate fused with the finish, and
  :func:`accumulate_packed.accumulate_packed_sums`, its sums alone (the
  column-sharded tile step);
* :func:`accumulate_sums.accumulate_sums` and
  :func:`accumulate_sums.accumulate_sums_counts` -- kernel 4, the segment
  accumulate of (branch, score) cells, without and with counts;
  :func:`accumulate_sums.accumulate_sums_counts_csr`, its row-pointer form with
  counts over the scatter engine's flat cells;
* :func:`tokenize.tokenize_combo_fused` -- the pair-plane slot tokenizer: the
  slot rows, lengths and window counts of a packed read buffer (the dense
  pair-plane steps).

Each wrapper counts its kernel launches in a ``launches`` attribute;
:func:`reset_launch_counts` zeroes them and :func:`launch_counts` reads them.
"""

from .accumulate_packed import accumulate_packed_sums, accumulate_packed_topk
from .accumulate_sums import accumulate_sums, accumulate_sums_counts, accumulate_sums_counts_csr
from .finish import finish_topk, finish_topk_counts
from .finish_cols import finish_cols_partial, finish_cols_partial_counts
from .rowgather import (
    rowgather_sum,
    rowgather_sum_cols,
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_counts_cols,
    rowgather_sum_counts_topk,
    rowgather_sum_counts_topk_bf16,
    rowgather_sum_topk,
    rowgather_sum_topk_int16,
)
from .tokenize import tokenize_combo_fused

__all__ = ["KERNELS", "accumulate_packed_sums", "accumulate_packed_topk", "accumulate_sums",
           "accumulate_sums_counts", "accumulate_sums_counts_csr", "finish_cols_partial",
           "finish_cols_partial_counts",
           "finish_topk", "finish_topk_counts", "launch_counts",
           "reset_launch_counts", "rowgather_sum", "rowgather_sum_cols",
           "rowgather_sum_counts", "rowgather_sum_counts_bf16", "rowgather_sum_counts_cols",
           "rowgather_sum_counts_topk",
           "rowgather_sum_counts_topk_bf16", "rowgather_sum_topk", "rowgather_sum_topk_int16",
           "tokenize_combo_fused"]

#: name -> wrapper, for every kernel of the port
KERNELS = {
    "rowgather_sum": rowgather_sum,
    "rowgather_sum_topk": rowgather_sum_topk,
    "rowgather_sum_topk_int16": rowgather_sum_topk_int16,
    "rowgather_sum_counts": rowgather_sum_counts,
    "rowgather_sum_counts_bf16": rowgather_sum_counts_bf16,
    "rowgather_sum_counts_topk": rowgather_sum_counts_topk,
    "rowgather_sum_counts_topk_bf16": rowgather_sum_counts_topk_bf16,
    "finish_topk": finish_topk,
    "finish_topk_counts": finish_topk_counts,
    "rowgather_sum_cols": rowgather_sum_cols,
    "rowgather_sum_counts_cols": rowgather_sum_counts_cols,
    "finish_cols_partial": finish_cols_partial,
    "finish_cols_partial_counts": finish_cols_partial_counts,
    "accumulate_packed_topk": accumulate_packed_topk,
    "accumulate_packed_sums": accumulate_packed_sums,
    "accumulate_sums": accumulate_sums,
    "accumulate_sums_counts": accumulate_sums_counts,
    "accumulate_sums_counts_csr": accumulate_sums_counts_csr,
    "tokenize_combo_fused": tokenize_combo_fused,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
