"""Service-axis sharded anneal on one card (port of ``solver/sharded.py``).

The reference shards the PROBLEM over the ``svc`` axis of a device mesh:
each mesh position owns S/D services (its slice of demand, conflict ids,
eligibility and preference) while every position of a replica holds a
copy of that replica's node state (load, conflict and colocation
occupancy, topology counts), kept equal by two collectives a sweep: a
``pmin`` that elects one winning move per target node across the shards,
and ``psum``s of the applied state deltas. A ``replica`` axis adds
parallel tempering: each replica anneals the whole problem at its own
temperature and neighbouring replicas exchange configurations.

This port runs a mesh whose positions all name ONE device (the reference
runs the same path on a mesh of virtual devices whenever it has fewer
chips than the mesh). A shard is then a view of the padded (S, ·) planes,
read as (D, S/D, ·); the replicated node state is held once per replica,
(R, ...) like K1's chains; and one sweep of every position is kernel K7
(``csrc/k7_sharded_sweep.cu``): the shards are thread blocks, the ``pmin``
a global ``atomicMin``, the ``psum`` a reduction over the shard blocks in
shard order, and the replica exchange an index over the replica axis. Its
plain PyTorch version is :func:`sharded_step_plain`. A mesh over distinct
cards (collectives over NCCL) is not built here: it raises SolverError.

The block loops, best-ever tracking, the exchange rounds and the scores
are plain PyTorch driven from the host, one K7 launch a sweep and one host
sync a block. The winner's exact stats come from a K3 rebuild of the whole
padded assignment (service order), so its load differs from the
reference's per-shard-then-psum rebuild by float32 rounding only.

Proposals come from a ``torch.Generator`` (:class:`TorchDraws`) or from
any object with the same two methods, the one seam through which the
tests hand in the reference's ``jax.random`` draws.

Entry points: :func:`anneal_sharded`, :func:`solve_sharded` over a
:class:`ShardedResident`, and the routing hooks :func:`sharded_route` and
:func:`maybe_solve_sharded` (``solver/api.solve``, ``sched/gpu.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _ext
from ..core.errors import SolverError
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from .anneal import (W_CAP, W_CONF, W_ELIG, W_SKEW, ChainState,
                     _proposal_delta, _ptr, chain_states_from_assignment,
                     solve_trace_blocks, violation_total_from_parts)
from .buckets import pad_problem
from .kernels import CAP_TOL, k3_rebuild
from .problem import TorchProblem, eligible_lookup
from .resident import ResidentProblem, merge_delta

log = get_logger("solver.sharded")

__all__ = ["anneal_sharded", "pad_problem", "shard_problem",
           "per_device_bytes", "SVC_AXIS", "REPLICA_AXIS", "ShardedStats",
           "tempering_mesh", "tempering_swap_delta", "tempering_swap_accept",
           "ShardedResident", "solve_sharded", "sharded_route",
           "maybe_solve_sharded", "Mesh", "visible_devices", "TorchDraws",
           "sharded_step_apply", "sharded_step_plain", "merge_sharded",
           "ShardedSweepLauncher", "sweep_launcher",
           "SHARDED_TRACE_COLS", "SHARDED_RANGE"]

SVC_AXIS = "svc"
REPLICA_AXIS = "replica"

# the torch.profiler range around a sharded dispatch (a warm one must make
# no host-to-device copy)
SHARDED_RANGE = "fleet.sharded"

_M_SHARDED = REGISTRY.counter(
    "fleet_solver_sharded_solves_total",
    "Pod-scale sharded solves by staging outcome: delta = warm re-solve "
    "from mesh-resident buffers, cold = full host staging",
    labels=("outcome",))
_M_SWAPS = REGISTRY.counter(
    "fleet_solver_tempering_swaps_total",
    "Parallel-tempering replica-exchange attempts by outcome",
    labels=("accepted",))
_M_SH_BYTES = REGISTRY.gauge(
    "fleet_solver_sharded_device_bytes",
    "Per-device bytes of the most recent sharded solve: problem tensors "
    "(service-axis shards + replicated node state) plus the anneal's "
    "chain/tempering working state")

# per-block telemetry rows of the sharded dispatch
SHARDED_TRACE_COLS = ("sweep", "temperature", "best_violations",
                      "best_soft", "swap_attempts", "swap_accepts")

_INT_MAX = 2**31 - 1


# -- the mesh -----------------------------------------------------------------

def visible_devices() -> list:
    """The cards this process sees, one torch.device each."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of mesh positions (the reference's
    ``jax.sharding.Mesh``): `devices` is a nested sequence shaped like
    `axis_names`, each entry a device or its name. Every position must
    name the SAME device: the positions then share one card (or the CPU),
    and the shard axis becomes K7's thread blocks. A mesh over distinct
    devices raises SolverError."""

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(names):
            raise ValueError(f"a mesh of axes {names} needs a "
                             f"{len(names)}-d device grid, got {grid.shape}")
        flat = [torch.device(x) for x in grid.reshape(-1)]
        distinct = list(dict.fromkeys(flat))
        if len(distinct) != 1:
            raise SolverError(
                f"a mesh over {len(distinct)} distinct devices needs the "
                f"multi-card sharded path (NCCL collectives, ROADMAP queue "
                f"1 item 5); every position of this port's mesh names one "
                f"device")
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))
        self.device = distinct[0]

    def _key(self):
        return (self.axis_names, tuple(self.shape.values()), self.device)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def tempering_mesh(replicas: int = 1, svc_shards: Optional[int] = None,
                   devices=None) -> Mesh:
    """The (replica, svc) mesh of the tempered sharded solve: `replicas`
    annealing lanes, each sharding the service axis `svc_shards` ways.
    `devices` (default: the visible cards) lists one device per position;
    every one must be the same device."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    replicas = max(int(replicas), 1)
    if svc_shards is None:
        svc_shards = max(len(devices) // replicas, 1)
    need = replicas * svc_shards
    if len(devices) < need:
        raise ValueError(f"tempering mesh needs {need} devices "
                         f"({replicas} replicas x {svc_shards} shards), "
                         f"have {len(devices)}")
    grid = [devices[r * svc_shards:(r + 1) * svc_shards]
            for r in range(replicas)]
    return Mesh(grid, (REPLICA_AXIS, SVC_AXIS))


def tempering_swap_delta(e_a, e_b, beta_a, beta_b):
    """Log acceptance ratio of exchanging the configurations of replicas a
    and b: (β_a − β_b)(E_a − E_b)."""
    return (beta_a - beta_b) * (e_a - e_b)


def tempering_swap_accept(e_a, e_b, beta_a, beta_b, u):
    """Metropolis replica-exchange criterion, for tensors: accept with
    probability min(1, exp((β_a − β_b)(E_a − E_b))) given `u` uniform on
    [0, 1). Equal temperatures always accept."""
    d = torch.as_tensor(tempering_swap_delta(e_a, e_b, beta_a, beta_b))
    return u < torch.exp(torch.clamp(d, max=0.0))


class ShardedStats(NamedTuple):
    """Full return of anneal_sharded(..., return_stats=True): the winning
    padded assignment, exact stats of the winner (from a K3 rebuild) and
    the tempering swap counters. `sweeps` and `swap_attempts` are host
    ints (the host loop knows them); the rest are device tensors."""
    assignment: torch.Tensor     # (S,) i32, padded
    sweeps: int                  # sweeps actually run
    capacity: torch.Tensor       # f32, overloaded (node, resource) cells
    conflicts: torch.Tensor      # f32, same-node conflict pairs
    eligibility: torch.Tensor    # f32, real services on ineligible/invalid nodes
    skew: torch.Tensor           # f32, excess spread over max_skew
    soft: torch.Tensor           # f32, soft score of the winner (padded rows)
    swap_attempts: int           # replica-exchange attempts
    swap_accepts: torch.Tensor   # i32, accepted exchanges
    # (trace_blocks, len(SHARDED_TRACE_COLS)) f32; zero-filled on the fixed
    # scan path (no block loop to observe)
    telemetry: torch.Tensor

    @property
    def violations(self):
        return self.capacity + self.conflicts + self.eligibility + self.skew


def shard_problem(prob: TorchProblem, mesh: Mesh) -> TorchProblem:
    """Check that `prob` can run on its mesh: S divides over the svc axis
    and the problem lies on the mesh's device. The positions share that
    device, so a shard is a view of the (S, ·) planes (read as (D, S/D,
    ·)) and nothing is copied: returns `prob` itself."""
    D = mesh.shape[SVC_AXIS]
    if prob.S % D:
        raise ValueError(f"S={prob.S} must divide over {D} shards "
                         f"(use pad_problem first)")
    if prob.device != mesh.device:
        raise ValueError(f"the problem lies on {prob.device}, the mesh on "
                         f"{mesh.device}")
    return prob


_SHARDED_FIELDS = ("demand", "conflict_ids", "coloc_ids", "eligible",
                   "preferred")


def per_device_bytes(prob: TorchProblem, mesh: Mesh, *,
                     state: bool = False) -> dict[str, int]:
    """Bytes of each of `prob`'s tensors that ONE mesh position holds, key
    for key with the reference: a service-axis plane's S/D rows, a node
    plane whole. `state=True` adds the anneal's working state a position
    holds (``state_*``): its replica's node state and two S/D assignment
    buffers. On one card the positions share the device: its real total is
    ``torch.cuda.memory_allocated``."""
    D = mesh.shape[SVC_AXIS]
    out: dict[str, int] = {}
    names = ("demand", "capacity", "conflict_ids", "coloc_ids", "eligible",
             "node_valid", "node_topology", "preferred", "sticky_prev")
    for name, t in zip(names, prob.tensors()):
        if t is None or t.dim() == 0:
            continue
        nbytes = t.numel() * t.element_size()
        out[name] = nbytes // D if name in _SHARDED_FIELDS else nbytes
    if state:
        N, R = prob.N, prob.demand.shape[1]
        s_loc = prob.S // D
        out["state_load"] = N * R * 4
        out["state_used"] = N * prob.G * 4
        out["state_coloc"] = N * max(prob.Gc, 1) * 4
        out["state_topo"] = prob.T * 4
        out["state_assignment"] = s_loc * 4
        out["state_best_assignment"] = s_loc * 4
    return out


# -- K7: one sweep of every (replica, shard) position --------------------------

class TorchDraws:
    """The sharded sweep's proposals from a torch.Generator. Per position:
    half of the M services drawn categorically over the shard (weight 1 on
    services on an overloaded, conflicted, ineligible or invalid node,
    e^-30 elsewhere, the reference's logits 0 / -30), the rest uniformly;
    targets uniform over the nodes; u uniform on [0, 1). The exchange
    draws one uniform a replica; u[lo] decides the pair (lo, lo + 1)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def proposals(self, sweep: int, hot: torch.Tensor, N: int, M: int):
        """(s_loc, b_idx, u), each (R, D, M), for the `hot` (R, D, S/D)
        mask of the shards' services."""
        R, D, S_loc = hot.shape
        dev = hot.device
        weights = torch.where(hot, 1.0, float(np.exp(-30.0))).reshape(
            R * D, S_loc)
        half = M // 2
        parts = []
        if half:
            parts.append(torch.multinomial(weights, half, replacement=True,
                                           generator=self.gen))
        parts.append(torch.randint(0, S_loc, (R * D, M - half),
                                   generator=self.gen, device=dev))
        s_loc = torch.cat(parts, 1).to(torch.int32).view(R, D, M)
        b_idx = torch.randint(0, N, (R, D, M), generator=self.gen,
                              device=dev, dtype=torch.int32)
        u = torch.rand((R, D, M), generator=self.gen, device=dev,
                       dtype=torch.float32)
        return s_loc, b_idx, u

    def exchange(self, R: int, device) -> torch.Tensor:
        return torch.rand((R,), generator=self.gen, device=device,
                          dtype=torch.float32)


def _hot(prob: TorchProblem, st: ChainState, D: int) -> torch.Tensor:
    """(R, D, S/D): services on an overloaded, conflicted, ineligible or
    invalid node, per replica, grouped by shard."""
    R, S = st.assignment.shape
    over = (st.load > prob.capacity * CAP_TOL).any(-1)
    conf = (st.used * (st.used - 1)).sum(-1) > 0
    a = st.assignment.long()
    rows = torch.arange(S, device=a.device)[None]
    bad = ~eligible_lookup(prob.eligible, rows, a) | ~prob.node_valid[a]
    return (torch.gather(over | conf, 1, a) | bad).view(R, D, S // D)


def _check_step(prob: TorchProblem, st: ChainState, s_loc, b_idx, u, temps):
    if prob.sticky_prev is not None or prob.lanes:
        raise ValueError("the sharded sweep takes one problem without "
                         "stickiness")
    if s_loc.dim() != 3 or b_idx.shape != s_loc.shape \
            or u.shape != s_loc.shape:
        raise ValueError("sharded sweep: proposals must be (R, D, M)")
    R, D, _M = s_loc.shape
    if (s_loc.dtype != torch.int32 or b_idx.dtype != torch.int32
            or u.dtype != torch.float32
            or st.assignment.shape != (R, prob.S) or prob.S % D
            or len(temps) != R):
        raise ValueError("sharded sweep: (R, D, M) i32, i32, f32 proposals "
                         "for an (R, S) state, S a multiple of D, one "
                         "temperature per replica")


def sharded_step_plain(prob: TorchProblem, st: ChainState,
                       s_loc: torch.Tensor, b_idx: torch.Tensor,
                       u: torch.Tensor, temps):
    """Plain PyTorch version of K7; see :func:`sharded_step_apply`."""
    _check_step(prob, st, s_loc, b_idx, u, temps)
    R, D, M = s_loc.shape
    S, N = prob.S, prob.N
    S_loc = S // D
    dev = s_loc.device
    shard = torch.arange(D, device=dev)[None, :, None]
    s = (shard * S_loc + s_loc.long()).reshape(R, D * M)
    b = b_idx.long().reshape(R, D * M)
    a = torch.gather(st.assignment, 1, s).long()
    delta = _proposal_delta(prob, st, s, a, b)
    t = torch.clamp(torch.tensor(temps, dtype=torch.float32, device=dev),
                    min=1e-8)[:, None]
    accept = (((delta < 0) | (u.reshape(R, D * M) < torch.exp(-delta / t)))
              & (a != b))
    # winner per service: its lowest accepted proposal (a service lies in
    # one shard, so the shard-local index orders it)
    m = torch.arange(M, device=dev).repeat(D).expand(R, D * M)
    winner = torch.full((R, S), M, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, s, torch.where(accept, m, M), "amin")
    cand = accept & (torch.gather(winner, 1, s) == m)
    # the election across shards: rank = m + M·shard, lowest per node
    d_of = shard.expand(R, D, M).reshape(R, D * M)
    rank = torch.where(cand, m + M * d_of, M * D)
    best = torch.full((R, N), M * D, dtype=torch.int64, device=dev)
    best.scatter_reduce_(1, b, rank, "amin")
    applied = cand & (torch.gather(best, 1, b) == rank)
    w = applied.to(torch.float32)
    wi = applied.to(torch.int32)

    # each position's load delta (departures, then arrivals, in proposal
    # order), summed over the shards in shard order, then added
    rix = torch.arange(R, device=dev)[:, None]
    pos = rix * D + d_of
    dem = prob.demand[s]
    part = torch.zeros((R * D * N, 3), dtype=torch.float32, device=dev)
    part.index_add_(0, (pos * N + a).reshape(-1),
                    (-dem * w[..., None]).reshape(-1, 3))
    part.index_add_(0, (pos * N + b).reshape(-1),
                    (dem * w[..., None]).reshape(-1, 3))
    part = part.view(R, D, N, 3)
    total = part[:, 0]
    for d in range(1, D):
        total = total + part[:, d]
    st.load.copy_(st.load + total)

    def occupancy(plane, ids):
        width = plane.shape[2]
        v = (ids >= 0).to(torch.int32) * wi[..., None]
        sf = torch.where(ids >= 0, ids, 0).long()
        flat = plane.view(-1)
        flat.index_add_(0, ((rix * N + a)[..., None] * width + sf).reshape(-1),
                        -v.reshape(-1))
        flat.index_add_(0, ((rix * N + b)[..., None] * width + sf).reshape(-1),
                        v.reshape(-1))

    occupancy(st.used, prob.conflict_ids[s])
    occupancy(st.coloc, prob.coloc_ids[s])
    wt = wi * (s < prob.real_rows).to(torch.int32)
    T = st.topo.shape[1]
    topo = prob.node_topology.long()
    st.topo.view(-1).index_add_(0, (rix * T + topo[a]).reshape(-1),
                                -wt.reshape(-1))
    st.topo.view(-1).index_add_(0, (rix * T + topo[b]).reshape(-1),
                                wt.reshape(-1))
    flat_assign = st.assignment.view(-1)
    flat_assign[(rix * S + s)[applied]] = b.to(torch.int32)[applied]
    return st, wi.view(R, D, M).sum(2).to(torch.int32)


class _Scratch(NamedTuple):
    # 4·R·D·M candidates, the positions' touched-node lists (R·D·2M) and
    # lengths (R·D), R·N marks, then R·N election slots
    ints: torch.Tensor
    partial: torch.Tensor   # (R, D, N, 3) load deltas


def _scratch_ints(R: int, D: int, M: int, N: int) -> int:
    return 6 * R * D * M + R * D + 2 * R * N


def _scratch(R: int, D: int, M: int, N: int, dev) -> _Scratch:
    """K7's scratch: the marks and the election slots at INT_MAX, the
    partials at 0 (the kernel leaves them so after every sweep)."""
    return _Scratch(
        torch.full((_scratch_ints(R, D, M, N),), _INT_MAX, dtype=torch.int32,
                   device=dev),
        torch.zeros(R * D * N * 3, dtype=torch.float32, device=dev))


class ShardedSweepLauncher:
    """K7 bound to one problem, one (R, ...) replica state and one scratch
    for the sweeps of one sharded anneal call: the inputs are checked, the
    C arguments built, the launch shape computed (``ff_k7_bind``) and the
    library looked up once, and each sweep passes only its draws and the
    replicas' temperatures. It launches on the stream current when it was
    built, into one `applied` buffer it returns from every call (read it
    before the next sweep; stream order makes that safe). Build one per
    call and drop it with the call: a replaced or merged problem must
    never be launched through its pointers. Every sweep draws (R, D, M)
    proposals."""

    def __init__(self, prob: TorchProblem, st: ChainState, D: int, M: int,
                 scratch: Optional[_Scratch] = None):
        if prob.sticky_prev is not None or prob.lanes:
            raise ValueError("the sharded sweep takes one problem without "
                             "stickiness")
        if st.assignment.dim() != 2 or st.assignment.shape[1] != prob.S \
                or prob.S % D:
            raise ValueError("sharded sweep: an (R, S) state, S a multiple "
                             "of D")
        R = st.assignment.shape[0]
        dev = st.assignment.device
        if scratch is None:
            scratch = _scratch(R, D, M, prob.N, dev)
        elif (scratch.ints.numel() != _scratch_ints(R, D, M, prob.N)
                or scratch.partial.numel() != R * D * prob.N * 3):
            raise ValueError("sharded_step_apply: scratch of another shape")
        _ext.check_inputs("sharded_step_apply", *st, prob.demand,
                          prob.capacity, prob.conflict_ids, prob.coloc_ids,
                          prob.eligible, prob.node_valid, prob.node_topology,
                          prob.preferred, *scratch)
        self.dev, self.R = dev, R
        self.shape = (R, D, M)
        self.lanes = _ext.lanes_arg([prob.real_rows] * R)
        lib = _ext.library("k7_sharded_sweep")
        if lib.ff_k7_static_size() != ctypes.sizeof(_ext.K7Args):
            raise RuntimeError("k7_sharded_sweep: the C argument struct does "
                               "not match _ext.K7Args")
        self.args = _ext.K7Args(
            _ext.ProblemArgs(
                prob.S, prob.N, prob.G, st.coloc.shape[-1],
                st.topo.shape[-1], prob.conflict_ids.shape[-1],
                prob.coloc_ids.shape[-1], prob.demand.data_ptr(),
                prob.capacity.data_ptr(), prob.conflict_ids.data_ptr(),
                prob.coloc_ids.data_ptr(), prob.eligible.data_ptr(),
                int(prob.eligible_packed), prob.eligible.shape[-1],
                prob.node_valid.data_ptr(), prob.node_topology.data_ptr(),
                _ptr(prob.preferred), 0, 0.0, prob.strategy, prob.max_skew,
                prob.real_rows),
            R, D, M, st.assignment.data_ptr(), st.load.data_ptr(),
            st.used.data_ptr(), st.coloc.data_ptr(), st.topo.data_ptr(),
            scratch.ints.data_ptr(), scratch.partial.data_ptr(), 0, 0, 0, 0)
        lib.ff_k7_bind.argtypes = [ctypes.c_void_p]
        _ext.raise_error("k7_sharded_sweep",
                         lib.ff_k7_bind(ctypes.addressof(self.args)))
        self.fn = lib.ff_k7_sweep
        self.fn.argtypes = [ctypes.c_void_p, _ext.Lanes, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p]
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.applied = torch.empty((R, D), dtype=torch.int32, device=dev)
        # the prob/state/scratch tensors stay alive while the pointers are
        # in use
        self._keep = (prob, st, scratch)

    def __call__(self, s_loc: torch.Tensor, b_idx: torch.Tensor,
                 u: torch.Tensor, temps) -> torch.Tensor:
        """One sweep at `temps` (one temperature a replica); returns the
        applied moves (R, D)."""
        for x, dt in ((s_loc, torch.int32), (b_idx, torch.int32),
                      (u, torch.float32)):
            if (x.shape != self.shape or x.dtype != dt
                    or x.device != self.dev or not x.is_contiguous()):
                raise ValueError(
                    "sharded sweep: proposals must be contiguous "
                    f"{self.shape} i32, i32, f32 on {self.dev}")
        if len(temps) != self.R:
            raise ValueError("sharded sweep: one temperature per replica")
        lanes = self.lanes
        for i in range(self.R):
            lanes.temp[i] = temps[i]
        _ext.raise_on("k7_sharded_sweep", self.fn(
            ctypes.addressof(self.args), lanes, s_loc.data_ptr(),
            b_idx.data_ptr(), u.data_ptr(), self.applied.data_ptr(),
            self.stream))
        return self.applied


def sweep_launcher(prob: TorchProblem, st: ChainState, D: int, M: int):
    """The per-sweep K7 call of a sharded anneal loop over D shards: a
    :class:`ShardedSweepLauncher` on the card, on the CPU the plain
    version. Called as fn(s_loc, b_idx, u, temps) with one temperature a
    replica; returns the applied moves (R, D)."""
    if st.assignment.device.type == "cpu":
        def plain(s_loc, b_idx, u, temps):
            return sharded_step_plain(prob, st, s_loc, b_idx, u, temps)[1]
        return plain
    return ShardedSweepLauncher(prob, st, D, M)


def sharded_step_apply(prob: TorchProblem, st: ChainState,
                       s_loc: torch.Tensor, b_idx: torch.Tensor,
                       u: torch.Tensor, temps, scratch: Optional[_Scratch] = None):
    """K7: one sweep of every (replica, shard) position of a mesh on one
    device. `st` is the replicas' state (R, ...) over the padded problem,
    the proposals (R, D, M) each: shard d of replica r proposes moving its
    service d·S/D + s_loc[r, d, m] to node b_idx[r, d, m] with uniform
    u[r, d, m]. Every delta is taken against the pre-sweep state at the
    replica's temperature temps[r]; the lowest accepted proposal of a
    service is its candidate, the lowest rank m + M·d of the candidates
    aimed at a node wins it, and the winners are applied to `st` in place
    (the load in the reference's order: per-shard partials summed in shard
    order). Returns (st, applied moves (R, D) int32). `scratch` may be
    reused across sweeps (one is made when None). The one-shot form of
    :class:`ShardedSweepLauncher`, which an anneal loop binds once."""
    if s_loc.device.type == "cpu":
        return sharded_step_plain(prob, st, s_loc, b_idx, u, temps)
    _check_step(prob, st, s_loc, b_idx, u, temps)
    R, D, M = s_loc.shape
    sweep = ShardedSweepLauncher(prob, st, D, M, scratch)
    return st, sweep(s_loc, b_idx, u, temps)


# -- scores of the replicas' state (plain PyTorch) -----------------------------

def _shard_sum(x: torch.Tensor, D: int) -> torch.Tensor:
    """(R,) sums of (R, S) rows: per shard, then over the shards in shard
    order (the reference's per-position sum and psum)."""
    parts = x.reshape(x.shape[0], D, -1).sum(2)
    total = parts[:, 0]
    for d in range(1, D):
        total = total + parts[:, d]
    return total


def _inelig(prob: TorchProblem, a: torch.Tensor, real: torch.Tensor):
    """(R,) real services on an ineligible or invalid node."""
    a = a.long()
    rows = torch.arange(prob.S, device=a.device)[None]
    bad = ~eligible_lookup(prob.eligible, rows, a) | ~prob.node_valid[a]
    return (bad & real).sum(1)


def _soft(prob: TorchProblem, a: torch.Tensor, load: torch.Tensor,
          coloc: torch.Tensor, D: int) -> torch.Tensor:
    """(R,) soft score from the replicas' state, term for term the
    reference's soft_here; the mean denominators count phantom rows."""
    u = load / torch.clamp(prob.capacity, min=1e-6)
    usq = (u * u).sum((1, 2))
    denom = float(max(prob.N, 1))
    s_denom = float(max(prob.S, 1))
    if prob.strategy == 0:
        soft = usq / denom
    elif prob.strategy == 1:
        soft = -usq / denom
    else:
        soft = _shard_sum(a.to(torch.float32) / denom, D) / s_denom
    if prob.preferred is not None:
        rows = torch.arange(prob.S, device=a.device)[None]
        soft = soft + (-_shard_sum(prob.preferred[rows, a.long()], D)
                       / s_denom)
    if prob.Gc > 0:
        cc = coloc.to(torch.float32)
        soft = soft + (-(cc * (cc - 1.0) / 2.0).sum((1, 2)) / s_denom)
    return soft


def _scores(prob, st: ChainState, real, D: int):
    """(violations (R,), soft (R,)) of the replicas' state."""
    viol = violation_total_from_parts(prob, st.load, st.used, st.topo,
                                      _inelig(prob, st.assignment, real))
    return viol, _soft(prob, st.assignment, st.load, st.coloc, D)


def _energy(prob, st: ChainState, real, D: int) -> torch.Tensor:
    """(R,) annealing-cost energy the exchange criterion samples: overflow
    mass, conflict pairs, ineligibility and skew at their sweep weights,
    plus the soft score."""
    over = (torch.clamp(st.load - prob.capacity, min=0.0)
            / torch.clamp(prob.capacity, min=1e-6)).sum((1, 2)) * W_CAP
    c = st.used.to(torch.float32)
    conf = (c * (c - 1.0) / 2.0).sum((1, 2)) * W_CONF
    inel = _inelig(prob, st.assignment, real).to(torch.float32) * W_ELIG
    e = over + conf + inel
    if prob.max_skew > 0:
        spread = (st.topo.max(1).values - st.topo.min(1).values).to(
            torch.float32)
        e = e + torch.clamp(spread - prob.max_skew, min=0.0) * W_SKEW
    return e + _soft(prob, st.assignment, st.load, st.coloc, D)


class _Schedule:
    """The float32 temperatures of the reference: t0 · decay^i on the
    base schedule, times ladder^rep on a mesh with a replica axis."""

    def __init__(self, t0: float, t1: float, steps: int, ladder: float,
                 n_rep: int, has_rep: bool):
        self.t0 = np.float32(t0)
        self.decay = np.float32((t1 / t0) ** (1.0 / max(steps - 1, 1)))
        self.lad = [np.power(np.float32(ladder), np.float32(r)) if has_rep
                    else np.float32(1.0) for r in range(n_rep)]

    def base(self, i: int) -> np.float32:
        return self.t0 * np.power(self.decay, np.float32(i))

    def temps(self, i: int) -> list:
        b = self.base(i)
        return [float(b * lf) for lf in self.lad]


def anneal_sharded(prob: TorchProblem, init_assignment: torch.Tensor,
                   gen: Optional[torch.Generator] = None, steps: int = 64,
                   t0: float = 1.0, t1: float = 1e-3,
                   proposals_per_step: Optional[int] = None, *, mesh: Mesh,
                   adaptive: bool = False, block: int = 16,
                   n_real: Optional[int] = None, ladder: float = 1.3,
                   exchange_every: int = 1, return_sweeps: bool = False,
                   return_stats: bool = False, trace_blocks: int = 0,
                   draws=None, init_state: Optional[ChainState] = None):
    """One annealing pass with the service axis sharded over `mesh`.

    init_assignment: (S,) int32 on the mesh's device, S a multiple of the
    svc axis (pad_problem handles ragged S). Returns the refined (S,)
    assignment; `return_sweeps=True` returns (assignment, sweeps run);
    `return_stats=True` a :class:`ShardedStats`. The assignment is the
    lexicographically best (violations, soft) state ever visited.

    Three loops, as in the reference: without a replica axis the fixed
    scan (`adaptive=False`, `steps` sweeps) or the adaptive block loop
    (exit at the first block boundary after a feasible state was seen);
    with a replica axis (:func:`tempering_mesh`, even of one replica) the
    tempered block loop: replica r anneals at t(i)·ladder^r, neighbouring
    replicas exchange their whole configurations every `exchange_every`
    blocks (even/odd pairing alternating per round), the adaptive exit
    takes the best over replicas, and the winner is the best state any
    replica visited. A block's sweep indices are clamped at steps − 1.

    `n_real` marks rows >= n_real as phantoms (no topology weight, not
    counted as violations); None keeps `prob.n_real`. Proposals come from
    `draws` (an object with TorchDraws' methods), by default TorchDraws on
    `gen`. `init_state` starts from a given (R, ...) replica state instead
    of a K3 rebuild of `init_assignment`; it is updated in place."""
    D = mesh.shape[SVC_AXIS]
    has_rep = REPLICA_AXIS in mesh.shape
    n_rep = mesh.shape[REPLICA_AXIS] if has_rep else 1
    S, N = prob.S, prob.N
    shard_problem(prob, mesh)
    M = proposals_per_step or max(8, min(256, (S // D) // 2))
    if n_real is not None:
        prob = dataclasses.replace(prob, n_real=int(n_real))
    dev = prob.device
    if draws is None:
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        draws = TorchDraws(gen)
    sched = _Schedule(t0, t1, steps, ladder, n_rep, has_rep)
    real = (torch.arange(S, device=dev) < prob.real_rows)[None]
    if init_state is None:
        seed = init_assignment.to(device=dev, dtype=torch.int32).reshape(1, S)
        st = chain_states_from_assignment(prob, seed.expand(n_rep, S))
    else:
        st = init_state
    step = sweep_launcher(prob, st, D, M)
    viol, soft = _scores(prob, st, real, D)
    best = {"a": st.assignment.clone(), "v": viol, "s": soft}

    def sweep(i: int) -> None:
        s_loc, b_idx, u = draws.proposals(i, _hot(prob, st, D), N, M)
        step(s_loc, b_idx, u, sched.temps(i))
        v, f = _scores(prob, st, real, D)
        better = (v < best["v"]) | ((v == best["v"]) & (f < best["s"]))
        best["v"] = torch.where(better, v, best["v"])
        best["s"] = torch.where(better, f, best["s"])
        best["a"] = torch.where(better[:, None], st.assignment, best["a"])

    def exchange(b: int):
        """One replica-exchange round at block boundary `b`; returns
        (attempts, accepted 0-dim tensor)."""
        E = _energy(prob, st, real, D)
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
        # the betas as device scalars (a fill, not an upload), so their
        # difference is taken in float32 as in the reference
        beta = [torch.full((), float(x), dtype=torch.float32, device=dev)
                for x in betas]
        for lo in pairs:
            hi = lo + 1
            take = tempering_swap_accept(E[lo], E[hi], beta[lo], beta[hi],
                                         u[lo])
            perm[lo] = torch.where(take, hi, lo)
            perm[hi] = torch.where(take, lo, hi)
            acc = acc + take.to(torch.int32)
        for t in st:
            t.copy_(t.index_select(0, perm))
        return len(pairs), acc

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
            g_viol = best["v"].min()
            g_soft = torch.where(best["v"] == g_viol, best["s"],
                                 float("inf")).min()
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
    g_viol = best["v"].min()
    soft_m = torch.where(best["v"] == g_viol, best["s"], float("inf"))
    g_soft = soft_m.min()
    winner = (best["v"] == g_viol) & (soft_m == g_soft)
    sel = torch.where(winner, torch.arange(n_rep, device=dev), n_rep).min()
    best_assign = best["a"].index_select(0, sel.reshape(1))[0]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cap_f = conf_f = inel_f = skew_f = soft_f = zero
    if return_stats:
        # exact stats of the winner from a scratch K3 rebuild: the carried
        # load drifts over many scatter updates
        load, used, coloc, topo, _ = k3_rebuild(prob, best_assign)
        cap_f = (load > prob.capacity * CAP_TOL).sum().to(torch.float32)
        c = used.to(torch.float32)
        conf_f = (c * (c - 1.0) / 2.0).sum()
        inel_f = _inelig(prob, best_assign[None], real)[0].to(torch.float32)
        if prob.max_skew > 0:
            spread = topo.max() - topo.min()
            skew_f = torch.clamp(spread - prob.max_skew, min=0).to(
                torch.float32)
        soft_f = _soft(prob, best_assign[None], load, coloc, D)[0]
    stats = ShardedStats(best_assign, sweeps_run, cap_f, conf_f, inel_f,
                         skew_f, soft_f, att, acc, telem)
    if return_stats:
        return stats
    if return_sweeps:
        return best_assign, sweeps_run
    return best_assign


# -- mesh-resident sharded state: the pod path's warm re-solve -----------------

# the sharded merge: a shard is a view of the (S, ·) planes, so each row
# lands in its own shard through the one in-place merge
merge_sharded = merge_delta


class ShardedResident(ResidentProblem):
    """solver/resident.ResidentProblem on a mesh: the padded, bucketed
    problem padded further to a multiple of the svc axis and placed on the
    mesh's device (each shard a view), the last padded winner kept across
    bursts, churn merged in place (:func:`merge_sharded`). The per-burst
    uploads (masks, capacity, rows) happen at delta time; a warm dispatch
    copies nothing from the host."""

    # the sharded anneal sweeps the whole problem; churn-localized
    # sub-solves are a single-device path (solver/subsolve.py)
    supports_subsolve = False

    def __init__(self, pt, *, mesh: Mesh, bucket: bool = True, cfg=None):
        self.mesh = mesh
        super().__init__(pt, mesh.device, bucket=bucket, cfg=cfg)

    def _expected_padded_S(self, pt) -> int:
        # the bucket tier, rounded up so it divides over the svc axis
        s = super()._expected_padded_S(pt)
        D = self.mesh.shape[SVC_AXIS]
        return s + (-s) % D

    def cold_stage(self, pt) -> None:
        super().cold_stage(pt)
        prob, _ = pad_problem(self.prob, self.mesh.shape[SVC_AXIS])
        self.prob = shard_problem(prob, self.mesh)


def _host_seed(pt, parts: int) -> np.ndarray:
    """Cold host seed of the sharded path: the partitioned host FFD past
    S·N = 1e6, else the whole-instance host FFD. Raises SolverError when
    the host placer cannot be built (no fallback)."""
    if pt.S * pt.N >= 1_000_000:
        from .greedy import partitioned_seed
        return partitioned_seed(pt, max(parts, 1))
    from ..native.lib import native_place
    seed, _ = native_place(pt.demand, pt.capacity, pt.eligible,
                           pt.node_valid, pt.dep_depth, pt.port_ids,
                           pt.volume_ids, pt.anti_ids,
                           strategy=pt.strategy.value)
    return np.asarray(seed, np.int32)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name) or default)
    except ValueError:
        return default


def solve_sharded(pt, *, resident: ShardedResident,
                  resident_warm: bool = False, init_assignment=None,
                  steps: int = 64, seed: int = 0, t0: float = 1.0,
                  t1: float = 1e-3, adaptive: bool = True, block: int = 8,
                  ladder: Optional[float] = None,
                  exchange_every: Optional[int] = None):
    """End-to-end solve through the mesh-resident sharded path: the
    sharded anneal (with parallel tempering over the replica axis), exact
    stats, the host verify/repair backstop and a SolveResult.

    `resident_warm=True` seeds from the resident padded winner (churn
    already merged by `ShardedResident.apply_delta`) at t0 ≤ 0.1: nothing
    crosses the host boundary inside the ``fleet.sharded`` range. A cold
    solve seeds from the host FFD (`init_assignment` instead, at t0 ≤
    0.1). `ladder` (FLEET_TEMPER_LADDER, default 1.3) is the temperature
    ratio of neighbouring replicas, `exchange_every`
    (FLEET_TEMPER_EXCHANGE, default 1) the blocks between exchange
    rounds."""
    from .api import SolveResult, count_solve
    from .repair import repair, soft_score_host, verify

    t = time.perf_counter
    timings: dict = {}
    t_start = t()
    rp = resident
    mesh = rp.mesh
    prob = rp.prob
    dev = rp.device
    D = mesh.shape[SVC_AXIS]
    n_rep = mesh.shape.get(REPLICA_AXIS, 1)
    if ladder is None:
        ladder = _env_float("FLEET_TEMPER_LADDER", 1.3)
    if exchange_every is None:
        exchange_every = max(1, _env_int("FLEET_TEMPER_EXCHANGE", 1))
    warm = bool(resident_warm and rp.assignment is not None)
    if warm:
        timings["delta_stage_ms"] = rp.consume_delta_ms()
    timings["stage_ms"] = (t() - t_start) * 1e3

    t_seed = t()
    if warm:
        seed_assignment = rp.assignment
        t0 = min(t0, 0.1)      # warm start: refine, don't re-scramble
    else:
        if init_assignment is not None:
            seed_np = np.asarray(init_assignment, dtype=np.int32)
            t0 = min(t0, 0.1)
        else:
            seed_np = _host_seed(pt, D)
        # pads to the mesh's rows, phantoms on the first valid node
        rp.adopt_host(seed_np, pt.node_valid, warm=False)
        seed_assignment = rp.assignment
    timings["seed_ms"] = (t() - t_seed) * 1e3
    _M_SHARDED.inc(outcome="delta" if warm else "cold")

    t_anneal = t()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    trace_blocks = solve_trace_blocks()
    h2d0 = rp.h2d_copies
    with torch.profiler.record_function(SHARDED_RANGE):
        res = anneal_sharded(
            prob, seed_assignment, gen, steps=steps, t0=t0, t1=t1, mesh=mesh,
            adaptive=adaptive, block=block, ladder=float(ladder),
            exchange_every=int(exchange_every), return_stats=True,
            trace_blocks=trace_blocks)
    uploads = rp.h2d_copies - h2d0
    # the padded winner stays resident as the next warm seed
    rp.adopt(res.assignment)
    # one fetch of the scalars and telemetry, one of the assignment; a
    # copy, because on the CPU the numpy view would share storage with the
    # resident seed that the next merge updates in place
    host = torch.cat([torch.stack([res.capacity, res.conflicts,
                                   res.eligibility, res.skew, res.soft,
                                   res.swap_accepts.to(torch.float32)]),
                      res.telemetry.reshape(-1)]).cpu().numpy()
    padded = np.array(res.assignment.cpu().numpy(), dtype=np.int32,
                      copy=True)
    assignment = padded[:pt.S].copy()
    cap_f, conf_f, inel_f, skew_f, _soft_f, acc_f = host[:6]
    att, acc = int(res.swap_attempts), int(acc_f)
    timings["anneal_ms"] = (t() - t_anneal) * 1e3

    t_verify = t()
    moves = 0
    pre_repair = 0
    if float(cap_f + conf_f + inel_f + skew_f) == 0:
        stats = {"capacity": 0, "conflicts": 0, "eligibility": 0,
                 "skew": 0, "total": 0}
    else:
        stats = {k: int(v) for k, v in verify(pt, assignment).items()}
        pre_repair = int(stats["total"])
        if stats["total"] > 0:
            rr = repair(pt, assignment)
            assignment, moves = rr.assignment, rr.moves
            stats = {k: int(v) for k, v in rr.stats.items()}
            if moves:
                # the resident seed tracks what the fleet runs
                rp.adopt_host(assignment, pt.node_valid, warm=warm)
    # the real rows' soft score (the device number counts phantoms)
    soft = soft_score_host(pt, assignment)
    rp.note_host_assignment(padded=None if moves else padded,
                            feasible=stats["total"] == 0)
    timings["verify_repair_ms"] = (t() - t_verify) * 1e3
    timings["total_ms"] = (t() - t_start) * 1e3

    if att > 0:
        _M_SWAPS.inc(acc, accepted="true")
        _M_SWAPS.inc(att - acc, accepted="false")
    _M_SH_BYTES.set(float(sum(
        per_device_bytes(prob, mesh, state=True).values())))
    telemetry = None
    if trace_blocks > 0:
        filled = min(-(-res.sweeps // block), trace_blocks)
        rows = host[6:].reshape(trace_blocks, len(SHARDED_TRACE_COLS))[:filled]
        # a written row has a temperature > 0; the fixed scan writes none
        rows = rows[~np.all(rows == 0, axis=1)]
        telemetry = {
            "schema": list(SHARDED_TRACE_COLS),
            "blocks": [[round(float(x), 6) for x in row] for row in rows],
            "trace_blocks": trace_blocks,
            "exit_sweep": int(res.sweeps),
            "path": "sharded",
            "mesh": f"{n_rep}x{D}",
        }
    out = SolveResult(
        assignment=assignment, stats=stats, soft=float(soft),
        feasible=stats["total"] == 0, moves_repaired=moves,
        pre_repair_violations=pre_repair, timings_ms=timings,
        chains=n_rep, steps=int(res.sweeps),
        proposals_per_step=max(8, min(256, (prob.S // D) // 2)),
        accepted_moves=-1, telemetry=telemetry,
        warm_h2d_copies=uploads if warm else 0, device=str(dev),
        bucket={"orig_S": pt.S, "padded_S": prob.S,
                "pad_waste": round(1.0 - pt.S / prob.S, 4)},
        tempering={"replicas": n_rep, "ladder": float(ladder),
                   "exchange_every": int(exchange_every),
                   "swap_attempts": att, "swap_accepts": acc})
    # the solver's own families too: above the routing threshold these are
    # the only solves a fleet runs
    count_solve(out, pt, warm=warm, resident_warm=warm)
    if log.isEnabledFor(logging.INFO):
        log.info("solve_sharded %s", kv(
            S=pt.S, N=pt.N, padded=prob.S, mesh=f"{n_rep}x{D}",
            sweeps=int(res.sweeps), swaps=f"{acc}/{att}" if att else None,
            violations=int(stats["total"]), pre_repair=pre_repair,
            repaired=moves or None, warm=warm or None,
            **{k: f"{v:.1f}" for k, v in timings.items()}))
    return out


# -- routing: when does a solve take the sharded path? -------------------------

def sharded_route(pt) -> Optional[Mesh]:
    """Whether `pt` takes the sharded path, and on what mesh.
    `FLEET_SHARDED=0` disables, `=1` forces; otherwise instances with
    S·N >= FLEET_SHARDED_MIN_CELLS (default 5e7) route when >= 2 devices
    are visible. FLEET_SHARDED_REPLICAS picks the tempering replicas
    (default 2 with >= 4 devices, else 1); the rest shard the service
    axis. The devices are the visible cards: with one card there is
    nothing to route (as the reference with one chip), and a host of
    distinct cards stays on the single-card path until the multi-card
    slice (ROADMAP queue 1 item 5)."""
    mode = os.environ.get("FLEET_SHARDED", "").strip().lower()
    if mode in ("0", "off", "false", "no"):
        return None
    force = mode in ("1", "on", "true", "yes", "force")
    thresh = _env_int("FLEET_SHARDED_MIN_CELLS", 50_000_000)
    if not force and pt.S * pt.N < thresh:
        return None
    devs = [torch.device(d) for d in visible_devices()]
    if len(devs) < 2 or len(set(devs)) > 1:
        return None
    want = _env_int("FLEET_SHARDED_REPLICAS", 0)
    if want <= 0:
        replicas = 2 if len(devs) >= 4 else 1
    else:
        replicas = min(want, len(devs))
        if replicas != want:
            log.warning("FLEET_SHARDED_REPLICAS=%d clamped to %d (only %d "
                        "devices visible)", want, replicas, len(devs))
    return tempering_mesh(replicas, len(devs) // replicas, devices=devs)


# solve() kwargs the sharded path speaks; any other pins the call to the
# single-device pipeline (a knob this path would silently drop must not
# route)
_ROUTED_KW = {"steps", "seed", "init_assignment", "t0", "t1", "adaptive",
              "prob", "resident"}


def maybe_solve_sharded(pt, **kw):
    """solve()'s routing hook: above the threshold (or under
    FLEET_SHARDED=1) solve through a transient ShardedResident. None when
    the call stays on the single-device path: explicit staging kwargs
    (prob, resident) and knobs the sharded path does not speak always
    stay put. The scheduler routes itself (a ShardedResident slot per
    stage); this hook covers direct calls."""
    if any(kw.get(k) is not None for k in ("prob", "resident")):
        return None
    if not set(kw) <= _ROUTED_KW:
        return None
    mesh = sharded_route(pt)
    if mesh is None:
        return None
    rp = ShardedResident(pt, mesh=mesh)
    steps = kw.get("steps") or _env_int("FLEET_SHARDED_STEPS", 64)
    return solve_sharded(
        pt, resident=rp, steps=steps, seed=kw.get("seed", 0),
        init_assignment=kw.get("init_assignment"),
        t0=kw.get("t0", 1.0), t1=kw.get("t1", 1e-3),
        adaptive=kw.get("adaptive", True))
