"""The service-axis sharded anneal across ranks (``solver/sharded.py`` on a
mesh of ranks).

On a mesh of ranks (``parallel.init_multihost``; ``sharded.Mesh`` of
ints) each rank is one (replica r, shard d) position, as each device is in
the reference's ``shard_map``: it holds its shard's rows [d·S/D,
(d+1)·S/D) of the (S, ·) planes (a :class:`~.problem.TorchProblem` of
S/D rows, ``n_real`` its real rows), the node planes whole, and its
replica's node state once (a one-chain ChainState). A sweep is K7's
cross-rank form (``csrc/k7_sharded_sweep.cu``: elect, apply, reduce) with
two of the reference's collectives between the launches
(``collectives.py``):

    elect -> all_reduce(MIN) of the election slots over the replica's ranks
    apply -> all_gather of the position's records over the replica's ranks
             (its applied moves in proposal order: source, target, real
             row, ids, and the touched nodes' load partials; a fixed
             layout of min(M, N) moves, :func:`record_layout`)
    reduce (every position's integer deltas into the planes, the partials
            summed in shard order: the loads stay bit-equal to the
            one-device K7 and to the reference's CPU psum)

The reference sums dense delta planes (``psum``); integer sums are exact in
any order, so the records carry only what moved.

The block loop, best-ever tracking, adaptive exit and replica exchange
mirror the one-device loop of ``sharded.anneal_sharded`` step for step:
the scores' service-axis parts (the ineligible count, strategy 2's index
sum, the preference sum) are gathered over the replica's ranks and summed
in shard order, the per-block (violations, soft) of every replica is
gathered over the shard's ranks, so the exit and the winner's pick are
the same on every rank, and the exchange's ``ppermute`` is an all_gather
of the replicas' states over the shard's ranks from which each takes its
partner's. The winner's exact stats come from a per-shard K3 rebuild
summed in shard order (the reference's per-shard-then-psum rebuild), and
the padded winner is gathered, so every rank returns the same result.

Draws come through the same seam as on one device: the draw object is
handed an (R, D, S/D) hot mask whose rows other than this position's are
False and returns every position's (R, D, M) proposals, of which the rank
keeps its own; a generator seeded alike on every rank thus draws what the
one-device run draws (a row's multinomial draws depend on that row's
weights only).

Each of the three entry points has its plain PyTorch version here; a
wrapper given CPU tensors runs it, and on a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _ext
from . import collectives as coll
from .anneal import (W_CAP, W_CONF, W_ELIG, W_SKEW, ChainState,
                     _proposal_delta, _ptr, chain_states_from_assignment,
                     violation_total_from_parts)
from .kernels import CAP_TOL, k3_rebuild
from .problem import TorchProblem, eligible_lookup

__all__ = ["RankPosition", "rank_position", "shard_rows", "local_real",
           "RankScratch", "rank_scratch", "record_layout", "empty_records",
           "record_views", "sharded_elect",
           "sharded_elect_plain", "sharded_apply", "sharded_apply_plain",
           "sharded_reduce", "sharded_reduce_plain", "RankSweepLauncher",
           "rank_sweep", "rank_step", "anneal_ranks"]

_INT_MAX = 2**31 - 1
REPLICA_AXIS = "replica"
# set to a list to have every cross-rank sweep append its CUDA events
# around each entry point and collective, [(name, event), ...] a sweep (on
# the card; chip_smoke's [ranks] reads them)
SWEEP_EVENTS: Optional[list] = None
SVC_AXIS = "svc"
# the cycle stamps of elect and apply when K7's library is built with
# -DK7R_PHASES (csrc/k7_sharded_sweep.cu), slot -> phase, as
# tools/k7r_profile.py prints them ("_count" slots are counts)
PHASE_SLOTS = {
    "k7_rank_elect": {3: "topo", 4: "delta", 5: "cluster_wait", 6: "post",
                      7: "accepted_count", 9: "delta_longest_thread"},
    "k7_rank_apply": {3: "won", 4: "compact_push",
                      5: "cluster_wait", 6: "records_pass",
                      7: "applied_count", 9: "walk_longest_thread"},
    "k7_rank_reduce": {3: "counts", 4: "passes", 5: "owners",
                       7: "moves_count"},
}

# a proposal's standing after the election (the kernel's kRejected,
# kAccepted, kCandidate)
_REJECTED, _ACCEPTED, _CANDIDATE = 0, 1, 2


class RankPosition(NamedTuple):
    """This rank's place on a (replica, svc) mesh of ranks."""
    r: int        # its replica
    d: int        # its shard
    R: int        # replicas
    D: int        # shards
    S: int        # the global padded S
    row0: int     # its first global row

    @property
    def S_loc(self) -> int:
        return self.S // self.D


def rank_position(mesh, S_loc: int) -> RankPosition:
    """The position of this rank on `mesh` (a mesh of ranks) for shards
    of `S_loc` rows."""
    pos = mesh.position
    if pos is None:
        raise ValueError("this rank holds no position of the mesh")
    names = mesh.axis_names
    D = mesh.shape[SVC_AXIS]
    R = mesh.shape.get(REPLICA_AXIS, 1)
    d = pos[names.index(SVC_AXIS)]
    r = pos[names.index(REPLICA_AXIS)] if REPLICA_AXIS in names else 0
    return RankPosition(r, d, R, D, S_loc * D, d * S_loc)


def local_real(n_real: Optional[int], pos: RankPosition) -> int:
    """The shard's real rows for a global real-row count (phantoms are a
    suffix of the global rows)."""
    if n_real is None:
        return pos.S_loc
    return int(min(max(int(n_real) - pos.row0, 0), pos.S_loc))


_SHARD_FIELDS = ("demand", "conflict_ids", "coloc_ids", "eligible",
                 "preferred")


def shard_rows(prob: TorchProblem, pos: RankPosition) -> TorchProblem:
    """The rank's shard of a whole padded problem: its rows of the (S, ·)
    planes (owned copies), the node planes as they are, n_real its real
    rows."""
    if prob.S != pos.S:
        raise ValueError(f"shard_rows: a problem of S={prob.S}, the mesh's "
                         f"S={pos.S}")
    lo, hi = pos.row0, pos.row0 + pos.S_loc
    rows = {name: None if getattr(prob, name) is None
            else getattr(prob, name)[lo:hi].clone()
            for name in _SHARD_FIELDS}
    return dataclasses.replace(prob, **rows, S=pos.S_loc,
                               n_real=local_real(prob.n_real, pos))


# -- K7's cross-rank entry points and their plain versions --------------------

class RankScratch(NamedTuple):
    """The buffers between the three entry points: the proposals'
    (service, source, target, standing) (4, M) written by elect; the (N,)
    election slots (INT_MAX at rest); the position's records, written
    whole by apply (:func:`record_layout`) and gathered; `applied`, the
    records' count word (a (1,) view); the (S/D,) lowest accepted
    proposal of each of the shard's services, elect's own (INT_MAX at
    rest); reduce's (N, 4) node accumulator (an owner entry and the 3
    float bits of a sum; (-1, 0, 0, 0) at rest). The plain versions use
    neither of the last two."""
    cand: torch.Tensor
    slots: torch.Tensor
    records: torch.Tensor
    applied: torch.Tensor
    first: torch.Tensor
    acc: torch.Tensor


def record_layout(M: int, N: int, K: int, Kc: int) -> tuple:
    """(cap, move row ints, words) of a position's records: room for cap =
    min(M, N) applied moves (an applied move's target is its own across
    the replica), int32 words [count, 0, 0, 0], 2·cap node entries (node,
    the 3 float bits of its partial; (-1, 0, 0, 0) where empty), cap move
    rows (source, target, real row, the K conflict ids, the Kc coloc ids;
    -1 past the count), -1 up to a multiple of 4 words. The kernel's
    ``record_words`` computes the same."""
    cap = min(M, N)
    wm = 3 + K + Kc
    return cap, wm, 4 + 8 * cap + -(-cap * wm // 4) * 4


def record_views(rec: torch.Tensor, cap: int, wm: int):
    """(count (1,), entries (2·cap, 4), move rows (cap, wm)): views of a
    position's records."""
    ent = rec[4:4 + 8 * cap].view(2 * cap, 4)
    mv = rec[4 + 8 * cap:4 + 8 * cap + cap * wm].view(cap, wm)
    return rec[:1], ent, mv


def empty_records(cap: int, wm: int, words: int, device) -> torch.Tensor:
    """The records of a position that applied nothing."""
    rec = torch.full((words,), -1, dtype=torch.int32, device=device)
    rec[:4] = 0
    record_views(rec, cap, wm)[1][:, 1:] = 0
    return rec


def _layout(lp: TorchProblem, M: int) -> tuple:
    return record_layout(M, lp.N, lp.conflict_ids.shape[-1],
                         lp.coloc_ids.shape[-1])


def rank_scratch(lp: TorchProblem, st: ChainState, M: int) -> RankScratch:
    dev = st.assignment.device
    rec = empty_records(*_layout(lp, M), dev)
    acc = torch.zeros((lp.N, 4), dtype=torch.int32, device=dev)
    acc[:, 0] = -1
    return RankScratch(
        torch.zeros((4, M), dtype=torch.int32, device=dev),
        torch.full((lp.N,), _INT_MAX, dtype=torch.int32, device=dev),
        rec, rec[:1],
        torch.full((lp.S,), _INT_MAX, dtype=torch.int32, device=dev), acc)


def _check_rank(lp: TorchProblem, st: ChainState, pos: RankPosition) -> None:
    if lp.sticky_prev is not None or lp.lanes:
        raise ValueError("the sharded sweep takes one problem without "
                         "stickiness")
    if st.assignment.shape != (1, lp.S) or lp.S * pos.D != pos.S:
        raise ValueError("the cross-rank sweep: a one-replica (1, S/D) state "
                         "of the rank's shard")


def sharded_elect_plain(lp: TorchProblem, st: ChainState, sc: RankScratch,
                        pos: RankPosition, s_loc: torch.Tensor,
                        b_idx: torch.Tensor, u: torch.Tensor,
                        temp: float) -> None:
    """Plain PyTorch version of K7's elect; see :func:`sharded_elect`."""
    M = s_loc.shape[-1]
    dev = s_loc.device
    s = s_loc.long().reshape(1, M)
    b = b_idx.long().reshape(1, M)
    a = torch.gather(st.assignment, 1, s).long()
    # the move delta divides by the GLOBAL padded S; the shard's rows index
    # the shard's planes and its real rows
    lpg = dataclasses.replace(lp, S=pos.S, n_real=lp.real_rows)
    delta = _proposal_delta(lpg, st, s, a, b)
    t = torch.clamp(torch.tensor([temp], dtype=torch.float32, device=dev),
                    min=1e-8)[:, None]
    accept = (((delta < 0) | (u.reshape(1, M) < torch.exp(-delta / t)))
              & (a != b))
    m = torch.arange(M, device=dev)[None]
    winner = torch.full((1, lp.S), M, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, s, torch.where(accept, m, M), "amin")
    cand = accept & (torch.gather(winner, 1, s) == m)
    rank = (m + M * pos.d).to(torch.int32)
    sc.slots.scatter_reduce_(0, b[cand], rank[cand], "amin")
    standing = torch.where(cand, _CANDIDATE,
                           torch.where(accept, _ACCEPTED, _REJECTED))
    sc.cand.copy_(torch.cat([s, a, b, standing]).to(torch.int32))


def sharded_apply_plain(lp: TorchProblem, st: ChainState, sc: RankScratch,
                        pos: RankPosition) -> None:
    """Plain PyTorch version of K7's apply; see :func:`sharded_apply`."""
    M = sc.cand.shape[1]
    dev = sc.cand.device
    N = lp.N
    s, a, b, standing = (sc.cand[i].long() for i in range(4))
    m = torch.arange(M, device=dev)
    applied = (standing == _CANDIDATE) & (sc.slots.long()[b] == m + M * pos.d)
    w = applied.to(torch.float32)
    # the partials: departures, then arrivals, in proposal order from 0.0
    dem = lp.demand[s]
    part = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    part.index_add_(0, a, -dem * w[:, None])
    part.index_add_(0, b, dem * w[:, None])
    cap, wm, words = _layout(lp, M)
    rec = empty_records(cap, wm, words, dev)
    count, ent, mv = record_views(rec, cap, wm)
    sx, ax, bx = s[applied], a[applied], b[applied]
    n = sx.shape[0]
    count.fill_(n)
    mv[:n] = torch.cat([ax[:, None], bx[:, None],
                        (sx < lp.real_rows).long()[:, None],
                        lp.conflict_ids[sx].long(), lp.coloc_ids[sx].long()],
                       1).to(torch.int32)
    # entry 2x: x's source, when x is its first departure; 2x + 1: x's
    # target, when nothing leaves it
    x = torch.arange(n, device=dev)
    first = torch.full((N,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, ax, x, "amin")
    leaves = torch.zeros((N,), dtype=torch.bool, device=dev)
    leaves[ax] = True
    bits = part.view(torch.int32)
    for slot, nodes, keep in ((0, ax, first[ax] == x), (1, bx, ~leaves[bx])):
        nd = nodes[keep]
        ent[2 * x[keep] + slot] = torch.cat(
            [nd[:, None].to(torch.int32), bits[nd]], 1)
    sc.records.copy_(rec)
    st.assignment[0, sx] = bx.to(torch.int32)


def _move_ids(plane: torch.Tensor, ids: torch.Tensor, src: torch.Tensor,
              tgt: torch.Tensor) -> None:
    """Each move's ids (-1: none) leave its source's row of `plane` and
    enter its target's."""
    width = plane.shape[1]
    v = (ids >= 0).to(torch.int32)
    sf = torch.where(ids >= 0, ids, 0).long()
    flat = plane.view(-1)
    flat.index_add_(0, (src[:, None] * width + sf).reshape(-1),
                    -v.reshape(-1))
    flat.index_add_(0, (tgt[:, None] * width + sf).reshape(-1),
                    v.reshape(-1))


def sharded_reduce_plain(lp: TorchProblem, st: ChainState, sc: RankScratch,
                         pos: RankPosition, gathered: torch.Tensor) -> None:
    """Plain PyTorch version of K7's reduce; see :func:`sharded_reduce`."""
    cap, wm, _words = _layout(lp, sc.cand.shape[1])
    K = lp.conflict_ids.shape[-1]
    dev = gathered.device
    total = torch.zeros((lp.N, 3), dtype=torch.float32, device=dev)
    hit = torch.zeros((lp.N,), dtype=torch.bool, device=dev)
    topo = lp.node_topology.long()
    rows = torch.arange(2 * cap, device=dev)
    for rec in gathered:
        count, ent, mv = record_views(rec, cap, wm)
        mv = mv[rows[:cap] < count]
        src, tgt = mv[:, 0].long(), mv[:, 1].long()
        _move_ids(st.used[0], mv[:, 3:3 + K], src, tgt)
        _move_ids(st.coloc[0], mv[:, 3 + K:], src, tgt)
        real = (mv[:, 2] > 0).to(torch.int32)
        st.topo[0].index_add_(0, topo[src], -real)
        st.topo[0].index_add_(0, topo[tgt], real)
        sc.slots[tgt] = _INT_MAX
        # this shard's partials onto the sum of the shards before it
        ent = ent[rows < 2 * count]
        ent = ent[ent[:, 0] >= 0]
        node = ent[:, 0].long()
        total[node] = total[node] + ent[:, 1:].contiguous().view(torch.float32)
        hit[node] = True
    st.load[0].copy_(torch.where(hit[:, None], st.load[0] + total,
                                 st.load[0]))


class RankSweepLauncher:
    """K7's three cross-rank entry points bound to one rank's shard, its
    replica's state and one scratch for the sweeps of one anneal call
    (``ff_k7r_bind`` once: the tensors' devices, layouts and widths, and
    the clusters' shape); each launches on the stream current when it
    was built and counts its launch under its own name. A sweep passes
    only its draws' pointers and its temperature (elect) or the gathered
    records' pointer (reduce): the layout of the draws and of the
    gathered records is checked at the first call, since a call's come
    from one draw object and one gather. Build one per call and drop it
    with the call."""

    def __init__(self, lp: TorchProblem, st: ChainState, pos: RankPosition,
                 M: int, scratch: Optional[RankScratch] = None):
        _check_rank(lp, st, pos)
        dev = st.assignment.device
        sc = rank_scratch(lp, st, M) if scratch is None else scratch
        cap, _wm, words = _layout(lp, M)
        if (sc.cand.shape != (4, M) or sc.first.shape != (lp.S,)
                or sc.records.shape != (words,)
                or sc.acc.shape != (lp.N, 4)):
            raise ValueError("sharded sweep: scratch of another width")
        _ext.check_inputs("sharded_elect", *st, lp.demand, lp.capacity,
                          lp.conflict_ids, lp.coloc_ids, lp.eligible,
                          lp.node_valid, lp.node_topology, lp.preferred,
                          *sc)
        lib = _ext.library("k7_rank_elect")
        if lib.ff_k7r_static_size() != ctypes.sizeof(_ext.K7RankArgs):
            raise RuntimeError("k7_sharded_sweep: the C argument struct does "
                               "not match _ext.K7RankArgs")
        self.dev, self.M, self.scratch, self.pos = dev, M, sc, pos
        self.words = words
        self.args = _ext.K7RankArgs(
            _ext.ProblemArgs(
                pos.S, lp.N, lp.G, st.coloc.shape[-1], st.topo.shape[-1],
                lp.conflict_ids.shape[-1], lp.coloc_ids.shape[-1],
                lp.demand.data_ptr(), lp.capacity.data_ptr(),
                lp.conflict_ids.data_ptr(), lp.coloc_ids.data_ptr(),
                lp.eligible.data_ptr(), int(lp.eligible_packed),
                lp.eligible.shape[-1], lp.node_valid.data_ptr(),
                lp.node_topology.data_ptr(), _ptr(lp.preferred), 0, 0.0,
                lp.strategy, lp.max_skew, lp.real_rows),
            pos.D, pos.d, M, st.assignment.data_ptr(), st.load.data_ptr(),
            st.used.data_ptr(), st.coloc.data_ptr(), st.topo.data_ptr(),
            sc.slots.data_ptr(), sc.cand.data_ptr(), sc.first.data_ptr(),
            sc.acc.data_ptr(), sc.records.data_ptr(), cap, words)
        lib.ff_k7r_bind.argtypes = [ctypes.c_void_p]
        # the bind checks the three entry points' shapes: named by their
        # library
        _ext.raise_error("k7_sharded_sweep",
                         lib.ff_k7r_bind(ctypes.addressof(self.args)))
        self._addr = ctypes.addressof(self.args)
        self._elect = lib.ff_k7r_elect
        self._elect.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
        self._apply = lib.ff_k7r_apply
        self._apply.argtypes = [ctypes.c_void_p] * 2
        self._reduce = lib.ff_k7r_reduce
        self._reduce.argtypes = [ctypes.c_void_p] * 3
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self._draws_checked = self._gathered_checked = False
        self._keep = (lp, st)

    def _check_draws(self, s_loc, b_idx, u) -> None:
        for x, dt in ((s_loc, torch.int32), (b_idx, torch.int32),
                      (u, torch.float32)):
            if (x.numel() != self.M or x.dtype != dt or x.device != self.dev
                    or not x.is_contiguous()):
                raise ValueError(f"sharded elect: proposals must be "
                                 f"contiguous ({self.M},) i32, i32, f32 on "
                                 f"{self.dev}")
        self._draws_checked = True

    def elect(self, s_loc, b_idx, u, temp: float) -> None:
        if not self._draws_checked:
            self._check_draws(s_loc, b_idx, u)
        _ext.raise_on("k7_rank_elect", self._elect(
            self._addr, float(temp), s_loc.data_ptr(), b_idx.data_ptr(),
            u.data_ptr(), self.stream))

    def apply(self) -> None:
        _ext.raise_on("k7_rank_apply", self._apply(self._addr, self.stream))

    def reduce(self, gathered: torch.Tensor) -> None:
        if not self._gathered_checked:
            if (gathered.shape != (self.pos.D, self.words)
                    or gathered.dtype != torch.int32
                    or gathered.device != self.dev
                    or not gathered.is_contiguous()):
                raise ValueError(f"sharded reduce: contiguous ({self.pos.D}, "
                                 f"{self.words}) i32 records on {self.dev}")
            self._gathered_checked = True
        _ext.raise_on("k7_rank_reduce", self._reduce(
            self._addr, gathered.data_ptr(), self.stream))


class _PlainRankSweep:
    """The three plain versions behind the launcher's methods (the CPU)."""

    def __init__(self, lp, st, pos, M, scratch=None):
        _check_rank(lp, st, pos)
        self.lp, self.st, self.pos = lp, st, pos
        self.scratch = rank_scratch(lp, st, M) if scratch is None \
            else scratch

    def elect(self, s_loc, b_idx, u, temp):
        sharded_elect_plain(self.lp, self.st, self.scratch, self.pos, s_loc,
                            b_idx, u, temp)

    def apply(self):
        sharded_apply_plain(self.lp, self.st, self.scratch, self.pos)

    def reduce(self, gathered):
        sharded_reduce_plain(self.lp, self.st, self.scratch, self.pos,
                             gathered)


def rank_sweep(lp: TorchProblem, st: ChainState, pos: RankPosition, M: int,
               scratch: Optional[RankScratch] = None):
    """The cross-rank sweep's three entry points bound once: a
    :class:`RankSweepLauncher` on the card, the plain versions on the
    CPU."""
    if st.assignment.device.type == "cpu":
        return _PlainRankSweep(lp, st, pos, M, scratch)
    return RankSweepLauncher(lp, st, pos, M, scratch)


def sharded_elect(lp, st, sc, pos, s_loc, b_idx, u, temp) -> None:
    """K7's elect on one rank: the (M,) proposals of position (r, d)
    (shard-local services `s_loc`, targets `b_idx`, uniforms `u`) at
    temperature `temp` against the pre-sweep state `st` (one replica);
    each service's lowest accepted proposal is its candidate, which posts
    its rank m + M·d into `sc.slots` (atomicMin) and `sc.cand` records
    every proposal's service, source, target and standing."""
    rank_sweep(lp, st, pos, sc.cand.shape[1], sc).elect(s_loc, b_idx, u,
                                                        temp)


def sharded_apply(lp, st, sc, pos) -> None:
    """K7's apply on one rank, after the slots' MIN over the replica's
    ranks: the candidates that won their node move (the shard's
    assignment) and are written, in proposal order, to `sc.records`
    (:func:`record_layout`): each move's source, target, real row and
    ids, the touched nodes' load partials (a node's departures in
    proposal order, then its arrival, from 0.0), the applied count
    (`sc.applied`)."""
    rank_sweep(lp, st, pos, sc.cand.shape[1], sc).apply()


def sharded_reduce(lp, st, sc, pos, gathered) -> None:
    """K7's reduce on one rank, after the records' all_gather over the
    replica's ranks (`gathered`, (D, words) int32 in shard order): every
    position's moves' integer deltas go into the planes, the slots of
    their targets back to INT_MAX, and each touched node's load takes the
    partials summed in shard order; the scratch is back at rest."""
    rank_sweep(lp, st, pos, sc.cand.shape[1], sc).reduce(gathered)


def rank_step(sweep, svc: coll.Group, s_loc, b_idx, u,
              temp: float) -> torch.Tensor:
    """One cross-rank sweep: elect, MIN of the slots, apply, the records
    gathered, reduce; returns the position's applied moves (1,). With
    :data:`SWEEP_EVENTS` a list, the sweep's CUDA events around each entry
    point and collective are appended to it."""
    sc = sweep.scratch
    marks = [] if SWEEP_EVENTS is not None else None

    def mark(name):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    mark("start")
    sweep.elect(s_loc, b_idx, u, temp)
    mark("elect")
    coll.all_min_(sc.slots, svc)
    mark("all_min")
    sweep.apply()
    mark("apply")
    gathered = coll.all_gather(sc.records, svc)
    mark("gather")
    sweep.reduce(gathered)
    mark("reduce")
    if marks is not None:
        SWEEP_EVENTS.append(marks)
    return sc.applied


# -- the anneal loop over ranks -----------------------------------------------

def _inelig(lp: TorchProblem, a: torch.Tensor, real: torch.Tensor):
    a = a.long()
    rows = torch.arange(lp.S, device=a.device)[None]
    bad = ~eligible_lookup(lp.eligible, rows, a) | ~lp.node_valid[a]
    return (bad & real).sum(1)


def _hot(lp: TorchProblem, st: ChainState) -> torch.Tensor:
    """(1, S/D): the shard's services on an overloaded, conflicted,
    ineligible or invalid node of the replica's state."""
    over = (st.load > lp.capacity * CAP_TOL).any(-1)
    conf = (st.used * (st.used - 1)).sum(-1) > 0
    a = st.assignment.long()
    rows = torch.arange(lp.S, device=a.device)[None]
    bad = ~eligible_lookup(lp.eligible, rows, a) | ~lp.node_valid[a]
    return torch.gather(over | conf, 1, a) | bad


class _Scorer:
    """The scores of one replica's state on one rank, its service-axis
    parts gathered over the replica's ranks and summed in shard order,
    term for term the one-device ``sharded._scores``/``_energy``."""

    def __init__(self, lp: TorchProblem, pos: RankPosition, svc: coll.Group,
                 real: torch.Tensor):
        self.lp, self.pos, self.svc, self.real = lp, pos, svc, real

    def parts(self, a: torch.Tensor) -> torch.Tensor:
        """(3,) int32: the shard's ineligible count and the float bits of
        its strategy-2 and preference sums."""
        lp = self.lp
        dev = a.device
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        strat = (a.to(torch.float32) / float(max(lp.N, 1))).sum(1) \
            if lp.strategy == 2 else zero
        pref = zero
        if lp.preferred is not None:
            rows = torch.arange(lp.S, device=dev)[None]
            pref = lp.preferred[rows, a.long()].sum(1)
        return torch.cat([_inelig(lp, a, self.real).to(torch.int32),
                          strat.view(torch.int32), pref.view(torch.int32)])

    def reduce(self, parts: torch.Tensor):
        """(inelig (1,) i64, strat sum (1,) f32, pref sum (1,) f32) over
        the replica's shards."""
        g = coll.all_gather(parts, self.svc)
        inel = g[:, 0].long().sum().reshape(1)
        flt = g[:, 1:].contiguous().view(torch.float32)
        strat = coll.ordered_sum(None, None, parts=flt[:, 0:1])
        pref = coll.ordered_sum(None, None, parts=flt[:, 1:2])
        return inel, strat, pref

    def soft(self, load, coloc, strat, pref) -> torch.Tensor:
        lp = self.lp
        u = load / torch.clamp(lp.capacity, min=1e-6)
        usq = (u * u).sum((1, 2))
        denom = float(max(lp.N, 1))
        s_denom = float(max(self.pos.S, 1))
        if lp.strategy == 0:
            soft = usq / denom
        elif lp.strategy == 1:
            soft = -usq / denom
        else:
            soft = strat / s_denom
        if lp.preferred is not None:
            soft = soft + (-pref / s_denom)
        if lp.Gc > 0:
            cc = coloc.to(torch.float32)
            soft = soft + (-(cc * (cc - 1.0) / 2.0).sum((1, 2)) / s_denom)
        return soft

    def scores(self, st: ChainState):
        """(violations (1,), soft (1,), ineligible (1,)) of the state."""
        inel, strat, pref = self.reduce(self.parts(st.assignment))
        viol = violation_total_from_parts(self.lp, st.load, st.used, st.topo,
                                          inel)
        return viol, self.soft(st.load, st.coloc, strat, pref), inel

    def energy(self, st: ChainState, inel, soft) -> torch.Tensor:
        """(1,) annealing-cost energy of the state (its scores in hand)."""
        lp = self.lp
        over = (torch.clamp(st.load - lp.capacity, min=0.0)
                / torch.clamp(lp.capacity, min=1e-6)).sum((1, 2)) * W_CAP
        c = st.used.to(torch.float32)
        conf = (c * (c - 1.0) / 2.0).sum((1, 2)) * W_CONF
        e = over + conf + inel.to(torch.float32) * W_ELIG
        if lp.max_skew > 0:
            spread = (st.topo.max(1).values - st.topo.min(1).values).to(
                torch.float32)
            e = e + torch.clamp(spread - lp.max_skew, min=0.0) * W_SKEW
        return e + soft


def _pack(st: ChainState) -> torch.Tensor:
    """The replica's whole configuration as one int32 row (the float load
    by its bits)."""
    return torch.cat([st.assignment.reshape(-1),
                      st.load.reshape(-1).view(torch.int32),
                      st.used.reshape(-1), st.coloc.reshape(-1),
                      st.topo.reshape(-1)])


def _unpack_into(st: ChainState, row: torch.Tensor) -> None:
    sizes = [t.numel() for t in st]
    parts = torch.split(row, sizes)
    for t, p in zip(st, parts):
        if t.dtype == torch.float32:
            p = p.view(torch.float32)
        t.copy_(p.view(t.shape))


def anneal_ranks(lp: TorchProblem, init_assignment, draws, *, mesh,
                 steps: int, t0: float, t1: float, M: int, adaptive: bool,
                 block: int, n_real: Optional[int], ladder: float,
                 exchange_every: int, return_sweeps: bool,
                 return_stats: bool, trace_blocks: int,
                 init_state: Optional[ChainState] = None):
    """``sharded.anneal_sharded`` on a mesh of ranks; `lp` is this rank's
    shard (:func:`shard_rows`). `init_assignment` is the global (S,) or
    the shard's (S/D,); `init_state` a one-replica state of the shard
    (updated in place); `n_real` global. Returns what the one-device call
    returns, the padded winner gathered (every rank the same)."""
    from .sharded import ShardedStats, SHARDED_TRACE_COLS, _Schedule
    from .sharded import tempering_swap_accept

    pos = rank_position(mesh, lp.S)
    groups = mesh.my_groups()
    svc, rep = groups["svc"], groups["replica"]
    has_rep = REPLICA_AXIS in mesh.shape
    n_rep = pos.R
    N = lp.N
    if n_real is not None:
        lp = dataclasses.replace(lp, n_real=local_real(n_real, pos))
    dev = lp.device
    sched = _Schedule(t0, t1, steps, ladder, n_rep, has_rep)
    real = (torch.arange(lp.S, device=dev) < lp.real_rows)[None]
    if init_state is None:
        a0 = init_assignment.to(device=dev, dtype=torch.int32).reshape(-1)
        if a0.shape[0] == pos.S and pos.D > 1:
            a0 = a0[pos.row0:pos.row0 + pos.S_loc]
        if a0.shape[0] != lp.S:
            raise ValueError(f"anneal_sharded: an init of {a0.shape[0]} rows "
                             f"for shards of {lp.S} (global {pos.S})")
        st = chain_states_from_assignment(lp, a0.reshape(1, lp.S).clone())
        # the replica's node state: every shard's rows, the loads summed in
        # shard order (the reference's build_state psum)
        st.load.copy_(coll.ordered_sum(st.load, svc))
        for t in (st.used, st.coloc, st.topo):
            coll.all_sum_int_(t, svc)
    else:
        st = init_state
    step = rank_sweep(lp, st, pos, M)
    scorer = _Scorer(lp, pos, svc, real)
    viol, soft, inel = scorer.scores(st)
    best = {"a": st.assignment.clone(), "v": viol, "s": soft}
    last = {"inel": inel, "soft": soft}
    hot_full = torch.zeros((pos.R, pos.D, lp.S), dtype=torch.bool,
                           device=dev)

    def sweep(i: int) -> None:
        hot_full[pos.r, pos.d] = _hot(lp, st)[0]
        s_all, b_all, u_all = draws.proposals(i, hot_full, N, M)
        s_loc, b_idx, u = (x[pos.r, pos.d].contiguous()
                           for x in (s_all, b_all, u_all))
        rank_step(step, svc, s_loc, b_idx, u, sched.temps(i)[pos.r])
        v, f, inel = scorer.scores(st)
        last["inel"], last["soft"] = inel, f
        better = (v < best["v"]) | ((v == best["v"]) & (f < best["s"]))
        best["v"] = torch.where(better, v, best["v"])
        best["s"] = torch.where(better, f, best["s"])
        best["a"] = torch.where(better[:, None], st.assignment, best["a"])

    def exchange(b: int):
        E = coll.all_gather(scorer.energy(st, last["inel"], last["soft"]),
                            rep).reshape(-1)
        e = min((b + 1) * block - 1, steps - 1)
        temp_b = sched.base(e)
        betas = [np.float32(1.0) / np.maximum(temp_b * lf, np.float32(1e-8))
                 for lf in [np.power(np.float32(ladder), np.float32(r))
                            for r in range(n_rep)]]
        u = draws.exchange(n_rep, dev)
        parity = (b // exchange_every) % 2
        perm = torch.arange(n_rep, device=dev)
        acc = torch.zeros((), dtype=torch.int32, device=dev)
        pairs = range(parity, n_rep - 1, 2)
        beta = [torch.full((), float(x), dtype=torch.float32, device=dev)
                for x in betas]
        for lo in pairs:
            hi = lo + 1
            take = tempering_swap_accept(E[lo], E[hi], beta[lo], beta[hi],
                                         u[lo])
            perm[lo] = torch.where(take, hi, lo)
            perm[hi] = torch.where(take, lo, hi)
            acc = acc + take.to(torch.int32)
        states = coll.all_gather(_pack(st), rep)
        _unpack_into(st, states.index_select(0, perm[pos.r:pos.r + 1])[0])
        return len(pairs), acc

    def lead():
        """(every replica's best violations (R,), best softs (R,))."""
        g = coll.all_gather(torch.cat([best["v"], best["s"]]), rep)
        return g[:, 0], g[:, 1]

    telem = torch.zeros((trace_blocks, len(SHARDED_TRACE_COLS)),
                        dtype=torch.float32, device=dev)
    att = 0
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    if not has_rep and not adaptive:
        for i in range(steps):
            sweep(i)
        sweeps_run = steps
    else:
        n_blocks = -(-steps // block)
        b = 0
        done = False
        while not done and b < n_blocks:
            for j in range(block):
                sweep(min(b * block + j, steps - 1))
            if has_rep and n_rep > 1 and \
                    b % exchange_every == exchange_every - 1:
                d_att, d_acc = exchange(b)
                att += d_att
                acc = acc + d_acc
            bv, bs = lead()
            g_viol = bv.min()
            g_soft = torch.where(bv == g_viol, bs, float("inf")).min()
            if b < trace_blocks:
                full = lambda x: torch.full((), float(x), device=dev)  # noqa: E731
                telem[b] = torch.stack([
                    full(min((b + 1) * block, steps)),
                    full(sched.base(min((b + 1) * block - 1, steps - 1))),
                    g_viol, g_soft, full(att), acc.to(torch.float32)])
            b += 1
            if adaptive:
                done = bool(g_viol == 0)
        sweeps_run = min(b * block, steps)

    # the winner: the lexicographically best state any replica visited,
    # the lowest replica on a tie
    bv, bs = lead()
    g_viol = bv.min()
    soft_m = torch.where(bv == g_viol, bs, float("inf"))
    winner = (bv == g_viol) & (soft_m == soft_m.min())
    sel = torch.where(winner, torch.arange(n_rep, device=dev), n_rep).min()
    # the winner's rank of this shard sends its rows (an integer sum to
    # which the others add zeros: the host never reads the pick)
    mine = coll.all_sum_int_(
        torch.where(sel == pos.r, best["a"][0], 0).to(torch.int32), rep)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cap_f = conf_f = inel_f = skew_f = soft_f = zero
    if return_stats:
        # exact stats of the winner from a per-shard K3 rebuild summed in
        # shard order
        load, used, coloc, topo, _ = k3_rebuild(lp, mine[None])
        load = coll.ordered_sum(load, svc)
        for t in (used, coloc, topo):
            coll.all_sum_int_(t, svc)
        cap_f = (load > lp.capacity * CAP_TOL).sum().to(torch.float32)
        c = used.to(torch.float32)
        conf_f = (c * (c - 1.0) / 2.0).sum()
        inel, strat, pref = scorer.reduce(scorer.parts(mine[None]))
        inel_f = inel[0].to(torch.float32)
        if lp.max_skew > 0:
            spread = topo.max() - topo.min()
            skew_f = torch.clamp(spread - lp.max_skew, min=0).to(
                torch.float32)
        soft_f = scorer.soft(load, coloc, strat, pref)[0]
    best_assign = coll.all_gather(mine, svc).reshape(-1)
    stats = ShardedStats(best_assign, sweeps_run, cap_f, conf_f, inel_f,
                         skew_f, soft_f, att, acc, telem)
    if return_stats:
        return stats
    if return_sweeps:
        return best_assign, sweeps_run
    return best_assign
