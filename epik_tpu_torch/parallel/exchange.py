"""The model-axis exchange of a mesh row whose shards lie in several processes.

JAX's ``shard_map`` steps merge the model axis with ``psum``, ``pmax`` and
``all_gather`` (``epik_tpu/parallel/sharding.py:9-25``), and XLA runs them
across processes where a model group spans them. The port's steps merge the
shards' tensors in shard order with ``functools.reduce`` (``sharding.py``);
on a row that spans processes, :class:`ModelExchange` first gives every rank
of the row every shard's tensors, so that each rank runs the very merge a
single process runs, on the same tensors in the same order, and gets the
same bits. A gloo ``all_reduce(SUM)`` would add in another order on each
rank, and in another order than the single-process merge.

Transport: one gloo group a spanning row (``dist.new_group``; every rank of
the job makes every group, in row order, as ``new_group`` is a collective
over the world), on host tensors, staged through pinned memory from a card:
two ranks may share one card, which NCCL refuses. What crosses: a shard's
partial pack of the column finish (and its candidates' counts on the classic
plane) in the dense and tile steps, (R, Kl) and (R, 2 Kl + 3) a shard; the
(R, B) sums and counts (and the ambiguous reads' first hits) in the CSR
steps, as JAX's ``psum`` moves them. A collective that fails raises
:class:`~.mesh.CollectiveError`; no rank ever merges its own shards alone.
"""

from __future__ import annotations

import functools
import math
import threading
import time

import torch

from .mesh import DATA_AXIS, CollectiveError, Mesh, collective_timeout

__all__ = ["ModelExchange"]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor on its device."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class ModelExchange:
    """The row groups of a mesh over several processes, and the exchange of
    the shards' tensors within a row (:meth:`gather`). ``exchanges``,
    ``seconds`` and ``nbytes`` count this process's exchanges, their wall
    time (the staging copies, the collective and the wait for the row's
    slowest rank, from the moment the local shards' kernels have finished)
    and the bytes it received."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.exchanges = 0
        self.seconds = 0.0
        self.nbytes = 0
        self._lock = threading.Lock()
        self._groups: dict = {}
        if not mesh.multi_process:
            return
        import torch.distributed as dist

        timeout = collective_timeout()
        kw = {} if timeout is None else {"timeout": timeout}
        for d in range(mesh.shape[DATA_AXIS]):
            ranks = mesh.row_ranks(d)
            if len(ranks) > 1:
                group = dist.new_group(list(ranks), **kw)
                if mesh.rank in ranks:
                    self._groups[d] = group

    def row(self, d: int):
        """The exchange a step of data group ``d`` calls (``parts`` ->
        every shard's tensors), or None where the row's shards all lie in
        this process."""
        return functools.partial(self.gather, d) if d in self._groups else None

    def gather(self, d: int, parts: list) -> list[tuple[torch.Tensor, ...]]:
        """Every shard's tensors of data group ``d``, in shard order, on this
        process's first device of the row. ``parts[m]`` is shard ``m``'s tuple
        of tensors where this process holds the shard, else None; every
        shard's tuple has the same dtypes and shapes. One all-gather within
        the row's group: each rank sends its shards' bytes, padded to the
        most shards a rank of the row holds."""
        import torch.distributed as dist

        mesh = self.mesh
        owners = [mesh.owner(d, m) for m in range(len(parts))]
        local = [m for m, p in enumerate(parts) if p is not None]
        if local != [m for m, r in enumerate(owners) if r == mesh.rank]:
            raise ValueError(f"data group {d}: shards {local} given, this rank holds "
                             f"{[m for m, r in enumerate(owners) if r == mesh.rank]}")
        ranks = mesh.row_ranks(d)
        first = parts[local[0]]
        lead = first[0].device
        metas = [(t.dtype, t.shape) for t in first]
        sizes = [math.prod(shape) * dtype.itemsize for dtype, shape in metas]
        size = sum(sizes)
        per_rank = max(owners.count(r) for r in ranks)
        pin = lead.type == "cuda"
        if pin:  # the kernels behind the parts end before the clock starts
            torch.cuda.current_stream(lead).synchronize()
        t0 = time.perf_counter()
        send = torch.empty(per_rank * size, dtype=torch.uint8, pin_memory=pin)
        for i, m in enumerate(local):
            send[i * size:(i + 1) * size].copy_(torch.cat([_as_bytes(t) for t in parts[m]]))
        recv = [torch.empty(send.shape, dtype=torch.uint8, pin_memory=pin) for _ in ranks]
        try:
            dist.all_gather(recv, send, group=self._groups[d])
        except (RuntimeError, ConnectionError) as e:
            raise CollectiveError(f"model-axis exchange of data group {d} among ranks "
                                  f"{list(ranks)} failed: {e}") from e
        out, seen = [], {r: 0 for r in ranks}
        for m, r in enumerate(owners):
            i = seen[r]
            seen[r] += 1
            if parts[m] is not None:
                out.append(tuple(t.to(lead) for t in parts[m]))
                continue
            row = recv[ranks.index(r)][i * size:(i + 1) * size]
            tensors, off = [], 0
            for (dtype, shape), n in zip(metas, sizes):
                t = torch.empty(shape, dtype=dtype, device=lead)
                _as_bytes(t).copy_(row[off:off + n])
                tensors.append(t)
                off += n
            out.append(tuple(tensors))
        with self._lock:
            self.exchanges += 1
            self.seconds += time.perf_counter() - t0
            self.nbytes += size * (len(parts) - len(local))
        return out
