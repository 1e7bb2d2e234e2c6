"""The cross-rank collectives of the sharded anneal and the chain mesh.

The reference's device paths reduce across a mesh with ``pmin``,
``psum`` and ``ppermute``; here the positions are the ranks of a
``torch.distributed`` group (``parallel.init_multihost``) and the same
reductions use the three operations both backends carry on CUDA tensors:

* ``all_reduce`` with MIN (int32 or float32) and with SUM on int32 only;
* ``all_gather``;
* ``broadcast``.

A float32 sum is never an ``all_reduce(SUM)``: NCCL's reduction order is
unspecified. :func:`ordered_sum` gathers the parts and adds them in rank
order, ((p0 + p1) + p2) + ..., the order of the reference's CPU ``psum``
and of K7's shard reduction, so the loads stay bit-equal to both. The
replica exchange's ``ppermute`` is an :func:`all_gather` over the replica
group, from which each rank takes its partner's configuration.

A :class:`Group` is one line of a mesh (the ranks of one replica, of one
shard, or all of them); a group of one rank makes every operation the
identity without touching ``torch.distributed``. The groups of a mesh are
made by every rank in one order (:func:`groups_of`), as
``torch.distributed.new_group`` requires. Each operation adds its host
wall ms to :data:`STATS`.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

__all__ = ["Group", "groups_of", "all_min_", "all_sum_int_", "all_gather",
           "ordered_sum", "broadcast_", "STATS", "reset_stats",
           "forget_groups"]

# calls and host wall ms by operation, since the last reset_stats()
STATS: dict[str, list] = {}

# ranks -> process group, made once a process (every rank makes the same
# ones in the same order)
_PGS: dict[tuple, object] = {}


def reset_stats() -> None:
    STATS.clear()


def forget_groups() -> None:
    """Drop the made groups (the process left its group)."""
    _PGS.clear()


def _note(op: str, t0: float) -> None:
    s = STATS.setdefault(op, [0, 0.0])
    s[0] += 1
    s[1] += (time.perf_counter() - t0) * 1e3


class Group:
    """The ranks of one mesh line and this rank's index among them."""

    def __init__(self, ranks, rank: int):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.pg = None
        if self.size > 1:
            self.pg = _PGS[self.ranks]

    def __repr__(self) -> str:
        return f"Group({self.ranks}, index={self.index})"


def _make(lines) -> None:
    """Make the process groups of `lines` not made yet, in order; every
    rank of the world calls this with the same lines."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    for line in lines:
        if len(line) < 2 or line in _PGS:
            continue
        if list(line) == list(range(world)):
            _PGS[line] = dist.group.WORLD
        else:
            _PGS[line] = dist.new_group(list(line))


def groups_of(grid, rank: int) -> Optional[dict]:
    """The groups of a mesh's (R, D) rank grid for `rank`: "svc" (its
    replica's ranks, in shard order), "replica" (its shard's ranks, in
    replica order) and "mesh" (all, row by row); None when `rank` is not
    in the grid. A 1-D grid is one row. Every rank of the world makes
    every line's group, member or not."""
    import numpy as np
    g = np.asarray(grid).reshape(-1, np.asarray(grid).shape[-1])
    rows = [tuple(int(x) for x in r) for r in g]
    cols = [tuple(int(x) for x in c) for c in g.T]
    everyone = tuple(int(x) for x in g.reshape(-1))
    _make(rows + cols + [everyone])
    hit = np.argwhere(g == rank)
    if not len(hit):
        return None
    r, d = (int(x) for x in hit[0])
    return {"svc": Group(rows[r], rank), "replica": Group(cols[d], rank),
            "mesh": Group(everyone, rank)}


def _dist():
    import torch.distributed as dist
    return dist


def all_min_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """`t` (int32 or float32) replaced by its element-wise min over the
    group, in place."""
    if t.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"all_min_: int32 or float32, got {t.dtype}")
    if group.size > 1:
        t0 = time.perf_counter()
        dist = _dist()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group.pg)
        _note("all_min", t0)
    return t


def all_sum_int_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """`t` (int32) replaced by its element-wise sum over the group, in
    place. Integer sums are exact in any order."""
    if t.dtype != torch.int32:
        raise ValueError(f"all_sum_int_: int32 only, got {t.dtype} (a "
                         f"float sum is ordered_sum)")
    if group.size > 1:
        t0 = time.perf_counter()
        dist = _dist()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
        _note("all_sum_int", t0)
    return t


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """(group.size, *t.shape): every rank's `t`, in group order."""
    if group.size == 1:
        return t.unsqueeze(0)
    t0 = time.perf_counter()
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group.size)]
    _dist().all_gather(out, t, group=group.pg)
    stacked = torch.stack(out)
    _note("all_gather", t0)
    return stacked


def ordered_sum(t: torch.Tensor, group: Group,
                parts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of the ranks' `t` added in group order, ((t0 + t1) + t2)
    + ...; `parts` is the gathered (size, ...) when the caller has it."""
    if parts is None:
        parts = all_gather(t, group)
    total = parts[0]
    for i in range(1, parts.shape[0]):
        total = total + parts[i]
    return total


def broadcast_(t: torch.Tensor, src_index: int, group: Group) -> torch.Tensor:
    """`t` replaced by the group's member `src_index`'s, in place."""
    if group.size > 1:
        t0 = time.perf_counter()
        _dist().broadcast(t, src=group.ranks[int(src_index)],
                          group=group.pg)
        _note("broadcast", t0)
    return t
