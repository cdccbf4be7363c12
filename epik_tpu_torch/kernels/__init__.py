"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* :func:`rowgather.rowgather_sum` -- kernel 1, the row gather + sum (f32 or
  int16 plane); :func:`rowgather.rowgather_sum_counts` and
  :func:`rowgather.rowgather_sum_counts_bf16`, the same with exact counts over
  the classic plane (f32 or bf16); :func:`rowgather.rowgather_sum_topk` and
  :func:`rowgather.rowgather_sum_topk_int16`, the gather with the ambiguous
  delta rows and the finish fused in (the dense shifted steps);
* :func:`finish.finish_topk` -- kernel 2, correction + LWR + top-K + pack;
* :func:`accumulate_packed.accumulate_packed_topk` -- kernel 3, the packed
  posting-tile accumulate fused with the finish, and
  :func:`accumulate_packed.accumulate_packed_sums`, its sums alone (the
  column-sharded tile step);
* :func:`accumulate_sums.accumulate_sums` and
  :func:`accumulate_sums.accumulate_sums_counts` -- kernel 4, the segment
  accumulate of (branch, score) cells, without and with counts.

Each wrapper counts its kernel launches in a ``launches`` attribute;
:func:`reset_launch_counts` zeroes them and :func:`launch_counts` reads them.
"""

from .accumulate_packed import accumulate_packed_sums, accumulate_packed_topk
from .accumulate_sums import accumulate_sums, accumulate_sums_counts
from .finish import finish_topk
from .rowgather import (
    rowgather_sum,
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_topk,
    rowgather_sum_topk_int16,
)

__all__ = ["KERNELS", "accumulate_packed_sums", "accumulate_packed_topk", "accumulate_sums",
           "accumulate_sums_counts", "finish_topk", "launch_counts",
           "reset_launch_counts", "rowgather_sum", "rowgather_sum_counts",
           "rowgather_sum_counts_bf16", "rowgather_sum_topk", "rowgather_sum_topk_int16"]

#: name -> wrapper, for every kernel of the port
KERNELS = {
    "rowgather_sum": rowgather_sum,
    "rowgather_sum_topk": rowgather_sum_topk,
    "rowgather_sum_topk_int16": rowgather_sum_topk_int16,
    "rowgather_sum_counts": rowgather_sum_counts,
    "rowgather_sum_counts_bf16": rowgather_sum_counts_bf16,
    "finish_topk": finish_topk,
    "accumulate_packed_topk": accumulate_packed_topk,
    "accumulate_packed_sums": accumulate_packed_sums,
    "accumulate_sums": accumulate_sums,
    "accumulate_sums_counts": accumulate_sums_counts,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
