"""Time K1 (the sweep) and K2 (the fused pre-repair) of several checkouts of
fleetflow_tpu_torch on one card, at every size the main path launches them,
and split them into their phases.

    python3 fleetflow_tpu_torch/tools/k12_profile.py [--cases LIST] \
        TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and measures, on inputs made the same way in every tree,
the cases of LIST (comma-separated names; default all of them):

  k1        10k x 1k (chip_smoke's fleet), 2 chains (the K4 seed and a
            perturbed copy), 256 proposals a chain, at T = 1 and T = 1e-3
  k1-lanes  8 lanes x 2 chains of 2000x200 and 2 lanes x 2 chains of the
            10,848-row padded fleet (chip_smoke's lane stagings: nodes down
            and stickiness per lane), at T = 1 and T = 1e-3
  k2        10k x 1k with the 20 busiest nodes of the K4 seed down
            (chip_smoke's K2 check), 256 moves at most
  k2-mux    the mux leg's 2000x200 and 900x100 stagings (bucketed), from
            each stage's K4 seed, one node down and 15% of the nodes down:
            stage 0 alone and 8 stages as 8 lanes
  phases    K1 at 10k x 1k (T = 1, T = 1e-3) and K2 at 10k x 1k and at 8
            lanes of 2000x200 with 15% down, built with -DK1_PHASES
            -DK2_PHASES: each kernel's own cycle stamps, per phase

For each timed case it prints one JSON line: the median and spread of the
CUDA-event times of one wrapper call (K1: one sweep as the tree's anneal
loop launches it), the device time and device operations a call
(torch.profiler over the same calls), the wrapper's median host time (the
call returns after the launch), and the case's
moves: K1's applied moves, K2's moves and its iterations (the stranded
services it walks, at most 256; with lanes the longest lane) with the
event time per iteration. The phases case prints each phase's median over
the launches, in microseconds (K2: also per iteration), and the SM clock
the stamps imply, from a tree whose kernels have the stamps; a tree
without them says so. The card's name and
power limit come first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 50
CASES = ("k1", "k1-lanes", "k2", "k2-mux", "phases")
SLOTS = 12      # FF_PHASE_SLOTS in csrc/common.cuh
TEMPS = (1.0, 1e-3)
MAX_MOVES = 256


def _event_ms(torch, fn, setup, reps: int) -> list:
    times = []
    for i in range(reps + 2):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return sorted(times)


def _split(torch, fn, setup, reps: int) -> tuple:
    """(device ms a call, device operations a call, median host ms of the
    wrapper call) of `reps` calls under torch.profiler, each on its own
    inputs made before the profiled region."""
    from torch.profiler import ProfilerActivity, profile
    inputs = [setup() for _ in range(reps)]
    host = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    dev_us, ops = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
            ops += ev.count
    return dev_us / 1e3 / reps, ops / reps, statistics.median(host)


class Cases:
    """The inputs of every case, made the same way in every tree."""

    def __init__(self, tree: str, device: str = "cuda:0"):
        import numpy as np
        import torch

        import chip_smoke as cs
        from fleetflow_tpu_torch.lower import tensors as lower
        from fleetflow_tpu_torch.solver import (anneal, buckets, greedy,
                                                multiplex, problem)
        self.np, self.torch, self.cs, self.lower = np, torch, cs, lower
        self.anneal, self.buckets, self.greedy = anneal, buckets, greedy
        self.multiplex, self.problem = multiplex, problem
        self.tree = tree
        self.dev = torch.device(device)
        self.fleet = cs.mux_fleets(lower)
        pt = lower.synthetic_problem(10_000, 1_000, seed=0, n_tenants=8,
                                     port_fraction=0.2, volume_fraction=0.1)
        self.prob = problem.prepare_problem(pt, self.dev)
        self.seed = self.k4_seed(pt, self.prob)
        self.pt = pt

    def k4_seed(self, pt, prob):
        np, torch = self.np, self.torch
        order = np.concatenate([
            self.greedy.placement_order(
                pt.demand, pt.dep_depth, self.problem.unify_conflict_ids(pt)),
            np.arange(pt.S, prob.S, dtype=np.int32)])
        return self.greedy.greedy_place_batched(prob, torch.tensor(
            order, dtype=torch.int32, device=self.dev))

    def perturbed(self, seed, rng, pt=None):
        """chip_smoke's perturbed copy: a third of the services on nodes
        0-9, every service with a host port on node 0."""
        np, torch = self.np, self.torch
        S = seed.shape[-1]
        pert = seed.clone()
        cols = torch.tensor(rng.choice(S, S // 3, replace=False),
                            device=self.dev)
        pert[..., cols] = torch.tensor(
            rng.integers(0, 10, pert[..., cols].shape), dtype=torch.int32,
            device=self.dev)
        if pt is not None:
            ports = torch.tensor(np.flatnonzero((pt.port_ids >= 0).any(1)),
                                 device=self.dev)
            pert[..., ports] = 0
        return pert

    def stranded(self, prob, a) -> int:
        """Services of the (S,) assignment `a` on an ineligible or invalid
        node: what K2 walks."""
        torch = self.torch
        rows = torch.arange(prob.S, device=a.device)
        bad = (~self.problem.eligible_lookup(prob.eligible, rows, a.long())
               | ~prob.node_valid[a.long()])
        return int(bad.sum())


def row(tree, case, times, split, **extra) -> dict:
    dev_ms, ops, host = split
    out = {"tree": tree, "case": case,
           "event_ms_median": statistics.median(times),
           "event_ms_min": times[0], "event_ms_max": times[-1],
           "device_ms": dev_ms, "device_ops_per_call": ops,
           "host_ms_median": host}
    out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def k1_cases(c: Cases, lanes: bool) -> None:
    np, torch, anneal = c.np, c.torch, c.anneal
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=c.dev)
    gen.manual_seed(1)
    setups = []
    if not lanes:
        both = torch.stack([c.seed, c.perturbed(c.seed, rng, c.pt)])
        base = anneal.chain_states_from_assignment(c.prob, both)
        M = anneal.default_proposals_per_step(c.prob.S)
        draws = anneal.draw_proposals(c.prob, base, gen, M)
        setups.append(("k1 10000x1000 C=2", c.prob, base, draws, None))
    else:
        tenant = c.cs.default_fleet(np, c.lower)[0]
        for label, pts in (
                ("k1 2000x200 L=8 C=2",
                 [c.fleet(2000, 200, i) for i in range(8)]),
                (f"k1 {tenant.S}x{tenant.N} L=2 C=2", [tenant, tenant])):
            lprob, solo, seeds = c.cs.lane_problems(
                np, torch, c.problem, c.buckets, pts, c.dev)
            both = torch.stack([seeds, c.perturbed(seeds, rng)],
                               1).contiguous()
            base = anneal.chain_states_from_assignment(lprob, both)
            M = anneal.default_proposals_per_step(lprob.S)
            per = [anneal.draw_proposals(solo[i], base.lane(i), gen, M)
                   for i in range(lprob.lanes)]
            draws = tuple(torch.stack([d[k] for d in per]) for k in range(3))
            setups.append((f"{label} (padded {lprob.S})", lprob, base,
                           draws, lprob.lanes))
    for label, prob, base, (s_idx, b_idx, u), L in setups:
        for T in TEMPS:
            temp = T if L is None else [T] * L
            st = base.clone()
            _, applied = anneal.batched_step_apply(prob, st, s_idx, b_idx,
                                                   u, temp)
            fn, setup = sweep_call(c, prob, base, (s_idx, b_idx, u), temp)
            row(c.tree, f"{label} T={T:g}", _event_ms(torch, fn, setup, REPS),
                _split(torch, fn, setup, min(REPS, 20)),
                applied=int(applied.sum()), proposals=int(s_idx.numel()))


def sweep_call(c: Cases, prob, base, draws, temp):
    """(fn, setup): one sweep as the tree's anneal loop launches it, on a
    fresh copy of `base` each call. A tree whose loop binds K1 once a call
    (anneal.sweep_launcher) times the bound launcher, built in the setup;
    an older tree times batched_step_apply, which its loop called."""
    anneal = c.anneal
    s_idx, b_idx, u = draws
    if hasattr(anneal, "sweep_launcher"):
        temps = temp if isinstance(temp, list) else [temp]

        def setup():
            st = base.clone()
            return (anneal.sweep_launcher(prob, st, s_idx.shape[-1]),)

        return (lambda sweep: sweep(s_idx, b_idx, u, temps)), setup

    def fn(st):
        anneal.batched_step_apply(prob, st, s_idx, b_idx, u, temp)

    return fn, (lambda: (base.clone(),))


def k2_inputs(c: Cases, mux: bool) -> list:
    """[(label, problem, one-chain state, longest lane's stranded)]."""
    np, torch, anneal = c.np, c.torch, c.anneal
    out = []
    if not mux:
        busiest = torch.bincount(c.seed.long(), minlength=c.prob.N).argsort(
            descending=True)[:20]
        valid = c.prob.node_valid.clone()
        valid[busiest] = False
        dead = dataclasses.replace(c.prob, node_valid=valid)
        st0 = anneal.chain_states_from_assignment(dead, c.seed)
        out.append(("k2 10000x1000 20 nodes down", dead, st0,
                    c.stranded(dead, c.seed)))
        return out
    for S, N in ((2000, 200), (900, 100)):
        for churn in ("1 node down", "15% down"):
            solos, seeds, stranded = [], [], []
            for i in range(8):
                pt = c.fleet(S, N, i)
                prob, _ = c.buckets.stage_problem_tiers(pt, device=c.dev)
                seed = c.k4_seed(pt, prob)
                if churn == "1 node down":
                    dead = [i % N]
                else:
                    dead = np.random.default_rng(10 + i).choice(
                        N, 3 * N // 20, replace=False)
                valid = prob.node_valid.clone()
                valid[torch.as_tensor(np.asarray(dead), device=c.dev)] = False
                prob = dataclasses.replace(prob, node_valid=valid)
                solos.append(prob)
                seeds.append(seed)
                stranded.append(c.stranded(prob, seed))
            st0 = anneal.chain_states_from_assignment(solos[0], seeds[0])
            out.append((f"k2 {S}x{N} {churn} (padded {solos[0].S})",
                        solos[0], st0, stranded[0]))
            lprob = c.multiplex.stack_problems(solos)
            lst0 = anneal.chain_states_from_assignment(lprob,
                                                       torch.stack(seeds))
            out.append((f"k2 {S}x{N} {churn} L=8", lprob, lst0,
                        max(stranded)))
    return out


def k2_cases(c: Cases, mux: bool) -> None:
    torch, anneal = c.torch, c.anneal
    for label, prob, st0, stranded in k2_inputs(c, mux):
        _, moves = anneal.prerepair_state_counted(prob, st0.clone(),
                                                  MAX_MOVES)

        def fn(st, prob=prob):
            anneal.prerepair_state_counted(prob, st, MAX_MOVES)

        setup = lambda st0=st0: (st0.clone(),)  # noqa: E731
        times = _event_ms(torch, fn, setup, REPS)
        iters = min(stranded, MAX_MOVES)
        row(c.tree, label, times, _split(torch, fn, setup, min(REPS, 20)),
            moves=moves.tolist(), iterations=iters,
            us_per_iteration=(statistics.median(times) * 1e3 / iters
                              if iters else None))


def phases_case(c: Cases) -> None:
    """The stamped kernels' phase split (see the module docstring)."""
    import ctypes

    from fleetflow_tpu_torch import _ext
    torch, anneal, np = c.torch, c.anneal, c.np
    libs = {k: _ext.library(k) for k in ("k1_sweep", "k2_prerepair")}
    if not all(hasattr(lib, "ff_set_phases") for lib in libs.values()):
        print(json.dumps({"tree": c.tree, "case": "phases",
                          "stamps": False}), flush=True)
        return
    buf = torch.zeros((64, SLOTS), dtype=torch.int64, device=c.dev)
    for lib in libs.values():
        if lib.ff_set_phases(ctypes.c_void_p(buf.data_ptr())) != 0:
            raise RuntimeError("cannot set the phase buffer")

    def stamped(fn, setup, blocks: int, reps: int = 30) -> np.ndarray:
        rows = []
        for _ in range(reps):
            args = setup()
            buf.zero_()
            fn(*args)
            torch.cuda.synchronize()
            rows.append(buf[:blocks].cpu().numpy().astype(np.float64))
        return np.stack(rows)            # (reps, blocks, SLOTS)

    def ns_per_cycle(r: np.ndarray) -> float:
        return float((r[..., 1] - r[..., 0]).sum() / r[..., 2].sum())

    def us(r: np.ndarray) -> np.ndarray:
        """The cycle columns (2-6, then 9-11) in microseconds, by the
        blocks' own ns-per-cycle ratio."""
        cols = r[..., [2, 3, 4, 5, 6, 9, 10, 11]]
        return cols * ns_per_cycle(r) / 1e3

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=c.dev)
    gen.manual_seed(1)
    both = torch.stack([c.seed, c.perturbed(c.seed, rng, c.pt)])
    base = anneal.chain_states_from_assignment(c.prob, both)
    M = anneal.default_proposals_per_step(c.prob.S)
    s_idx, b_idx, u = anneal.draw_proposals(c.prob, base, gen, M)
    for T in TEMPS:
        r = stamped(lambda st, T=T: anneal.batched_step_apply(
            c.prob, st, s_idx, b_idx, u, T), lambda: (base.clone(),), 2)
        t = us(r)
        names = ("delta", "scan_services", "scan_targets", "apply",
                 "apply_tables", "apply_float", "apply_integer")
        out = {"tree": c.tree, "case": f"phases k1 10000x1000 C=2 T={T:g}",
               "sm_mhz": 1e3 / ns_per_cycle(r),
               "block_us": statistics.median(t[..., 0].max(1))}
        out.update({n: float(np.median(t[..., 1 + i].max(1)))
                    for i, n in enumerate(names) if t[..., 1 + i].any()})
        out["applied"] = float(np.median(r[..., 7].sum(1)))
        print(json.dumps(out), flush=True)
    k2 = k2_inputs(c, False) + [x for x in k2_inputs(c, True)
                                if x[0] == "k2 2000x200 15% down L=8"]
    for label, prob, st0, _stranded in k2:
        L = prob.lanes or 1
        r = stamped(lambda st, prob=prob: anneal.prerepair_state_counted(
            prob, st, MAX_MOVES), lambda st0=st0: (st0.clone(),), L)
        t = us(r)
        slow = r[..., 7].argmax(1)       # each launch's longest lane
        pick = t[np.arange(len(t)), slow]
        iters = r[np.arange(len(r)), slow, 7]
        names = ("list", "score", "reduce", "commit")
        out = {"tree": c.tree, "case": f"phases {label}",
               "sm_mhz": 1e3 / ns_per_cycle(r),
               "block_us": float(np.median(pick[:, 0])),
               "iterations": float(np.median(iters))}
        out.update({n: float(np.median(pick[:, 1 + i]))
                    for i, n in enumerate(names)})
        out.update({f"{n}_per_iteration": float(np.median(
            pick[:, 1 + i] / np.maximum(iters, 1)))
            for i, n in enumerate(names) if i})
        print(json.dumps(out), flush=True)


def child(tree: str, cases, phases: bool) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from fleetflow_tpu_torch import _ext
    if phases:
        # a build of its own (the flags are part of the build's hash)
        _ext.NVCC_FLAGS = (*_ext.NVCC_FLAGS, "-DK1_PHASES", "-DK2_PHASES")
    _ext.build()
    c = Cases(tree)
    c.torch.use_deterministic_algorithms(False)
    if phases:
        phases_case(c)
        return
    if "k1" in cases:
        k1_cases(c, lanes=False)
    if "k1-lanes" in cases:
        k1_cases(c, lanes=True)
    if "k2" in cases:
        k2_cases(c, mux=False)
    if "k2-mux" in cases:
        k2_cases(c, mux=True)


def main(argv: list[str]) -> int:
    cases = CASES
    if argv[:1] == ["--cases"]:
        cases = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(cases) <= set(CASES):
            print(f"unknown case in {cases}; the cases: {CASES}",
                  file=sys.stderr)
            return 2
    if argv[:1] in (["--child"], ["--phases"]):
        child(argv[1], cases, argv[0] == "--phases")
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    timed = [x for x in cases if x != "phases"]
    runs = (["--child"] if timed else []) + (
        ["--phases"] if "phases" in cases else [])
    rc = 0
    for tree in argv:
        for mode in runs:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cases",
                 ",".join(timed or cases), mode, tree],
                capture_output=True, text=True, timeout=900)
            print(run.stdout, end="", flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
