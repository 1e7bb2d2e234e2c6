"""Greedy seeds (port of ``solver/greedy.py``).

Two kernels live here, each beside its plain PyTorch version.

Kernel K6, :func:`greedy_place`, is the per-service first-fit-decreasing
scan: one step per service in `order`, each scoring all N nodes against
the running state (conflicts, capacity fit, eligibility, validity, the
strategy score and the optional preference), taking the first argmax among
the feasible nodes, or the best-effort argmax when none is feasible (with
``best_effort=False``, node 0: the reference's argmax of an all-``_NEG``
row), and committing it. It replaces
``fleetflow_tpu/solver/greedy.py::greedy_place``.
On a CUDA tensor it launches ``csrc/k6_greedy_scan.cu``; on a CPU tensor it
runs :func:`greedy_place_plain`.

Kernel K4 :func:`greedy_place_batched` places services in
`order`, M at a time. For each batch it scores all M×N (service, node)
pairs against the shared state, lets each service pick a node by an
anti-herding rank over its feasible list, resolves within-batch collisions
with pairwise masks (earlier same-node batch-mates' demand must still fit,
and none may share a conflict id), commits the winners, retries the losers
once against the updated state, and commits the rest best-effort (the
anneal repairs them). It replaces
``fleetflow_tpu/solver/greedy.py::greedy_place_batched`` with
``_node_scores``, ``_conflict_rows``, ``_pairwise_ok`` and ``_commit``.

On a CUDA tensor it launches ``csrc/k4_greedy.cu`` once: one cooperative
grid walks every batch and round itself (and raises when the card cannot
co-schedule it); on a CPU tensor it runs
:func:`greedy_place_batched_plain`. The reference's ``lax.top_k`` puts the
lower index first among equal scores, which spread instances hit often
(empty nodes tie); both versions select by a stable descending order, and
both add a batch's demand to a node one service at a time in batch order.

:func:`partitioned_seed` is the host seed of the reference's mega-scale
path: service slices × disjoint round-robin node subsets, one host FFD
(``csrc/host/placer.cpp``) per slice on a thread pool.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _ext
from .problem import TorchProblem, eligible_row, eligible_rows

__all__ = ["placement_order", "greedy_place", "greedy_place_plain",
           "greedy_place_batched", "greedy_place_batched_plain",
           "partitioned_seed"]

_NEG = -1e30
# K4's limits (csrc/k4_greedy.cu): the batch's (choice, m) sort keys hold m
# in 10 bits, and every node's selection key sits in shared memory
K4_MAX_BATCH = 1024
K4_MAX_NODES = 49152


def placement_order(demand: np.ndarray, dep_depth: np.ndarray,
                    conflict_ids: np.ndarray | None = None) -> np.ndarray:
    """Host-side placement order: most-constrained-first, then
    first-fit-decreasing; dependency depth breaks ties."""
    norm = demand / np.maximum(demand.max(axis=0, keepdims=True), 1e-6)
    weight = norm.sum(axis=1)
    if conflict_ids is not None and conflict_ids.size:
        n_constraints = (conflict_ids >= 0).sum(axis=1)
        weight = weight + n_constraints * (weight.max() + 1.0)
    return np.lexsort((dep_depth, -weight)).astype(np.int32)


def greedy_place_plain(prob: TorchProblem, order: torch.Tensor,
                       best_effort: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K6; see :func:`greedy_place`. The
    reference's scan step by step, in its float32 expressions."""
    N, G = prob.N, prob.G
    dev = order.device
    cap = prob.capacity
    load = torch.zeros((N, prob.demand.shape[1]), dtype=torch.float32,
                       device=dev)
    used = torch.zeros((N, G), dtype=torch.int32, device=dev)
    assignment = torch.full((prob.S,), -1, dtype=torch.int32, device=dev)
    cap_eps = cap + 1e-6
    cap_div = torch.clamp(cap, min=1e-6)
    neg = torch.full((N,), _NEG, dtype=torch.float32, device=dev)
    if prob.strategy == 2:
        lowest = -torch.arange(N, dtype=torch.float32, device=dev)
    for s in order.tolist():
        d = prob.demand[s]
        ids = prob.conflict_ids[s]
        valid_ids = ids >= 0
        safe = torch.where(valid_ids, ids, 0).long()
        n_conf = (used[:, safe] * valid_ids[None, :]).sum(-1)
        new_load = load + d[None, :]
        fits = (new_load <= cap_eps).all(-1)
        elig_s = eligible_row(prob.eligible, s, N)
        ok = fits & elig_s & prob.node_valid & (n_conf == 0)
        u = new_load / cap_div
        usq = (u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1]) + u[:, 2] * u[:, 2]
        if prob.strategy == 0:
            score = -usq
        elif prob.strategy == 1:
            score = usq
        else:
            score = lowest
        if prob.preferred is not None:
            score = score + prob.preferred[s] * 0.5
        node = torch.argmax(torch.where(ok, score, neg))
        if best_effort:
            over = torch.clamp(new_load - cap, min=0.0)
            overflow = (over[:, 0] + over[:, 1]) + over[:, 2]
            fb = -(overflow * 1e3 + n_conf.to(torch.float32) * 1e3) + score
            fb_ok = elig_s & prob.node_valid
            best_fb = torch.argmax(torch.where(fb_ok, fb, fb - 1e15))
            node = torch.where(ok.any(), node, best_fb)
        load.index_add_(0, node.view(1), d[None, :])
        used.view(-1).index_add_(0, node * G + safe,
                                 valid_ids.to(torch.int32))
        assignment[s] = node.to(torch.int32)
    return assignment


def greedy_place(prob: TorchProblem, order: torch.Tensor,
                 best_effort: bool = True) -> torch.Tensor:
    """K6: place services one at a time in `order` ((S,) i32), each on the
    first best feasible node of its strategy score, or, when no node is
    feasible, best-effort (least overflow, fewest conflicts), or with
    `best_effort=False` node 0; returns the (S,) int32 assignment."""
    if order.dim() != 1 or order.shape[0] > prob.S:
        raise ValueError(f"order has shape {tuple(order.shape)}, expected "
                         f"at most ({prob.S},)")
    if order.device.type == "cpu":
        return greedy_place_plain(prob, order, best_effort)
    if order.dtype != torch.int32 or prob.demand.shape[1] != 3:
        raise ValueError("greedy_place: order must be int32, R=3")
    if prob.lanes:
        raise ValueError("greedy_place takes one problem, not lanes")
    S, N, G = prob.S, prob.N, prob.G
    K = prob.conflict_ids.shape[1]
    dev = order.device
    assignment = torch.empty(S, dtype=torch.int32, device=dev)
    # the exact occupancy, and the bitmap and load when they do not fit on
    # chip; the kernel needs none of it cleared
    lib = _ext.library("k6_greedy_scan")
    lib.ff_k6_scratch_ints.restype = ctypes.c_longlong
    scratch = torch.empty(lib.ff_k6_scratch_ints(N, G, K), dtype=torch.int32,
                          device=dev)
    _ext.check_inputs("greedy_place", order, prob.demand, prob.capacity,
                      prob.conflict_ids, prob.eligible, prob.node_valid,
                      prob.preferred)
    _ext.launch(
        "k6_greedy_scan", "ff_k6_greedy_scan", dev,
        S, N, G, prob.demand, prob.capacity, prob.conflict_ids, K,
        prob.eligible, int(prob.eligible_packed), prob.eligible.shape[1],
        prob.node_valid, prob.preferred, prob.strategy, int(best_effort),
        order, order.shape[0], assignment, scratch)
    return assignment


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Column median with the two middle values averaged for even length
    ((lo + hi) * 0.5, the reference's jnp.median)."""
    srt = torch.sort(x, dim=0).values
    n = x.shape[0]
    lo, hi = srt[(n - 1) // 2], srt[n // 2]
    return (lo + hi) * 0.5


def _in_order(acc: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              mask: torch.Tensor, rank: torch.Tensor,
              before: bool = False) -> torch.Tensor:
    """acc[idx[m]] += vals[m] for the masked m, one m at a time in index
    order, whatever the device: `rank` is each m's count of earlier masked
    m with its idx, so each round adds to distinct rows (index_add_ then
    adds once a row, exactly). Returns acc, or with `before` the (M, R)
    value each masked m found in its row before its own add (0 elsewhere)."""
    out = torch.zeros_like(vals) if before else None
    rounds = int(rank[mask].max()) + 1 if bool(mask.any()) else 0
    for t in range(rounds):
        sel = mask & (rank == t)
        rows = idx[sel]
        if before:
            out[sel] = acc[rows]
        acc.index_add_(0, rows, vals[sel])
    return out if before else acc


def greedy_place_batched_plain(prob: TorchProblem, order: torch.Tensor,
                               batch: int = 256, rounds: int = 2) -> torch.Tensor:
    """Plain PyTorch version of K4; see :func:`greedy_place_batched`."""
    S, N = prob.S, prob.N
    dev = order.device
    M = min(batch, S)
    n_batches = -(-S // M)
    order_p = torch.full((n_batches * M,), -1, dtype=torch.int64, device=dev)
    order_p[:S] = order.long()
    W = min(M, N)
    R = prob.demand.shape[1]
    cap = prob.capacity
    load = torch.zeros((N, R), dtype=torch.float32, device=dev)
    used = torch.zeros((N, prob.G), dtype=torch.int32, device=dev)
    assignment = torch.full((S,), -1, dtype=torch.int32, device=dev)
    arange_m = torch.arange(M, dtype=torch.int64, device=dev)
    earlier = torch.tril(torch.ones((M, M), dtype=torch.bool, device=dev), -1)
    med_cap = _median_midpoint(cap) if prob.strategy != 0 else None

    for j in range(n_batches):
        svc_raw = order_p[j * M:(j + 1) * M]
        live0 = svc_raw >= 0
        svc = torch.where(live0, svc_raw, 0)
        d_svc = prob.demand[svc]                                # (M, R)
        ids = prob.conflict_ids[svc]                            # (M, K)
        v = ids >= 0
        safe = torch.where(v, ids, 0).long()
        share = ((ids[:, None, :, None] == ids[None, :, None, :])
                 & v[:, None, :, None] & v[None, :, None, :]).any(-1).any(-1)
        elig_b = eligible_rows(prob.eligible, svc, N)          # (M, N)

        def choose(live):
            new_load = load[None, :, :] + d_svc[:, None, :]     # (M, N, R)
            fits = (new_load <= cap[None] + 1e-6).all(-1)
            u_after = new_load / torch.clamp(cap[None], min=1e-6)
            usq = ((u_after[..., 0] * u_after[..., 0]
                    + u_after[..., 1] * u_after[..., 1])
                   + u_after[..., 2] * u_after[..., 2])
            if prob.strategy == 0:
                score = -usq
            elif prob.strategy == 1:
                score = usq
            else:
                score = (-torch.arange(N, dtype=torch.float32, device=dev)
                         ).expand(M, N)
            if prob.preferred is not None:
                score = score + prob.preferred[svc] * 0.5
            over = torch.clamp(new_load - cap[None], min=0.0)
            overflow = (over[..., 0] + over[..., 1]) + over[..., 2]
            conflict = (used[:, safe] * v[None]).sum(-1).T > 0  # (M, N)
            hard_ok = fits & elig_b & prob.node_valid[None] & ~conflict
            masked = torch.where(hard_ok, score,
                                 torch.full_like(score, _NEG))
            topk = torch.sort(masked, dim=-1, descending=True,
                              stable=True).indices[:, :W]
            count_ok = torch.clamp(hard_ok.sum(-1), max=W)
            floor_ok = torch.clamp(count_ok - 1, min=0)
            if prob.strategy == 0:
                r = arange_m % W
                r_eff = torch.minimum((r * count_ok) // W, floor_ok)
            else:
                mean_d = torch.clamp(d_svc.sum(0) / M, min=1e-6)
                est = int(torch.clamp((med_cap / mean_d).min().to(torch.int32),
                                      1, M))
                r_eff = torch.minimum(arange_m // est, floor_ok)
            best_ok = torch.gather(topk, 1, r_eff[:, None])[:, 0]
            fb_score = (score - overflow * 1e3) - conflict.to(torch.float32) * 1e3
            fb_ok = elig_b & prob.node_valid[None]
            best_fb = torch.argmax(torch.where(fb_ok, fb_score,
                                               fb_score - 1e15), dim=-1)
            has_ok = hard_ok.any(-1)
            choice = torch.where(has_ok, best_ok, best_fb)
            # within-batch gate against the EARLIER live same-node mates,
            # their demand summed in index order
            same = ((choice[:, None] == choice[None, :])
                    & live[:, None] & live[None, :])
            mates = same & earlier
            prefix = _in_order(torch.zeros_like(load), choice, d_svc, live,
                               mates.sum(1), before=True)
            cap_ok = ((load[choice] + prefix) + d_svc
                      <= cap[choice] + 1e-6).all(-1)
            conf_ok = ~(mates & share).any(-1)
            return choice, live & cap_ok & conf_ok & has_ok

        def commit(choice, mask):
            # each node adds its committed services one at a time, in
            # batch order
            rank = ((choice[:, None] == choice[None, :]) & mask[:, None]
                    & mask[None, :] & earlier).sum(1)
            _in_order(load, choice, d_svc, mask, rank)
            wi = (v.to(torch.int32) * mask.to(torch.int32)[:, None])
            flat = choice[:, None] * prob.G + safe
            used.view(-1).index_add_(0, flat.reshape(-1), wi.reshape(-1))
            assignment[svc[mask]] = choice[mask].to(torch.int32)

        c1, ok1 = choose(live0)
        commit(c1, ok1)
        rest = live0 & ~ok1
        c_tail = c1
        if rounds > 1:
            c2, ok2 = choose(rest)
            commit(c2, ok2)
            rest, c_tail = rest & ~ok2, c2
        commit(c_tail, rest)
    return assignment


def greedy_place_batched(prob: TorchProblem, order: torch.Tensor,
                         batch: int = 256, rounds: int = 2) -> torch.Tensor:
    """K4: place services in `order` ((S,) i32), `batch` at a time, in
    `rounds` (1 or 2) collision rounds plus a best-effort tail; returns the
    (S,) int32 assignment."""
    if rounds not in (1, 2):
        raise ValueError(f"rounds must be 1 or 2, got {rounds}")
    if order.shape != (prob.S,):
        raise ValueError(f"order has shape {tuple(order.shape)}, "
                         f"expected ({prob.S},)")
    if order.device.type == "cpu":
        return greedy_place_batched_plain(prob, order, batch, rounds)
    if order.dtype != torch.int32 or prob.demand.shape[1] != 3:
        raise ValueError("greedy_place_batched: order must be int32, R=3")
    S, N, G = prob.S, prob.N, prob.G
    M = min(batch, S)
    if M > K4_MAX_BATCH or N > K4_MAX_NODES:
        raise ValueError(f"greedy_place_batched: the kernel takes batches up "
                         f"to {K4_MAX_BATCH} and up to {K4_MAX_NODES} nodes "
                         f"(one key a node in shared memory)")
    dev = order.device
    assignment = torch.empty(S, dtype=torch.int32, device=dev)
    # the running load, a node's 3 resources padded to one 16-byte word
    load = torch.empty((N, 4), dtype=torch.float32, device=dev)
    # a bit a node for each conflict id: the node holds a service with it
    taken = torch.empty((G, -(-N // 32)), dtype=torch.int32, device=dev)
    # live, choice, has_ok (M ints each), a live flag, the median capacity
    # (3 floats) and each batch's mean demand (3 floats a batch)
    scratch = torch.empty(3 * M + 4 + 3 * -(-S // M), dtype=torch.int32,
                          device=dev)
    _ext.check_inputs("greedy_place_batched", order, prob.demand,
                      prob.capacity, prob.conflict_ids, prob.eligible,
                      prob.node_valid)
    _ext.launch(
        "k4_greedy", "ff_k4_greedy", dev,
        S, N, G, prob.demand, prob.capacity,
        prob.conflict_ids, prob.conflict_ids.shape[1],
        prob.eligible, int(prob.eligible_packed), prob.eligible.shape[1],
        prob.node_valid, prob.preferred, prob.strategy,
        order, M, rounds, assignment, load, taken, scratch)
    return assignment


def partitioned_seed(pt, parts: int) -> np.ndarray:
    """Host seed for mega-scale solves: service slices × disjoint
    round-robin node subsets, one full-capacity host FFD per slice.

    Slice g owns every `parts`-th node and a contiguous 1/parts of the
    services, and FFDs them onto its own nodes at full capacity: the work
    drops from O(S·N) to O(S·N/parts), and the union is feasible by
    construction for capacity and conflicts (slices use disjoint nodes).
    What is left for the anneal: services whose eligible nodes all lie in
    other slices (best-effort in-slice, an eligibility violation each) and
    packing fragmented across node subsets. Returns (S,) int32. The host
    placer is required: without it this raises SolverError (the reference
    falls back to the whole-instance host greedy)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..native.lib import load, native_place

    load()
    S, N = pt.demand.shape[0], pt.capacity.shape[0]
    parts = max(1, min(parts, S, N))
    if parts == 1:
        seg, _viol = native_place(
            pt.demand, pt.capacity, pt.eligible, pt.node_valid,
            pt.dep_depth, pt.port_ids, pt.volume_ids, pt.anti_ids,
            strategy=pt.strategy.value)
        return seg
    out = np.empty(S, dtype=np.int32)
    bounds = np.linspace(0, S, parts + 1, dtype=int)

    def one_slice(g: int) -> None:
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        if hi <= lo:
            return
        nodes_g = np.arange(g, N, parts)
        seg, _viol = native_place(
            pt.demand[lo:hi],
            np.ascontiguousarray(pt.capacity[nodes_g]),
            np.ascontiguousarray(pt.eligible[lo:hi][:, nodes_g]),
            np.ascontiguousarray(pt.node_valid[nodes_g]),
            pt.dep_depth[lo:hi], pt.port_ids[lo:hi],
            pt.volume_ids[lo:hi], pt.anti_ids[lo:hi],
            strategy=pt.strategy.value)
        out[lo:hi] = nodes_g[seg]

    # the slices are independent (disjoint services and nodes) and ctypes
    # releases the GIL for the C call, so a thread pool runs them at once;
    # each worker writes a disjoint out[lo:hi]
    workers = min(parts, os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(one_slice, range(parts)))
    else:
        for g in range(parts):
            one_slice(g)
    return out
