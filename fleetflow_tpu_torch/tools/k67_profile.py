"""Time K6 (the per-service FFD scan) and K7 (the sharded sweep) of several
checkouts of fleetflow_tpu_torch on one card, at every size chip_smoke.py
runs them, and split them into their phases.

    python3 fleetflow_tpu_torch/tools/k67_profile.py [--cases LIST] \
        TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and measures, on inputs made the same way in every tree,
the cases of LIST (comma-separated names; default all of them):

  k6          chip_smoke's [k6_scan] cases: 10k x 1k spread, 2000 x 200
              pack, fill_lowest and best-effort (capacity at 45%), and
              512 x 3,000 spread with a preference plane (more nodes than
              a block has threads)
  k7          chip_smoke's [k7] stagings: the sharded fleet (9,997 x 1,000,
              padded to the mesh) over 1x8 and 2x4 one-card meshes, the
              partitioned seed with 5% of the nodes down
  k7-sharded  [sharded]'s stagings from their solves' winners: cold 1x8,
              the resident 2x4 (a cold solve and one burst killing the
              busiest node) and the XL fleet (29,997 x 3,000) cold 1x8
  phases      K6 at every k6 size and K7 at the k7 stagings, the tree's
              kernels built with -DK6_PHASES -DK7_PHASES: each kernel's own
              cycle stamps, per phase

K7 is timed as the tree's anneal loop launches it (a tree whose loop binds
K7 once a call, through sharded.sweep_launcher, times one sweep of the
bound launcher), at the warm schedule's start and end temperatures (t0
0.1 and t1 1e-3, replica r at ladder 1.3^r), one sweep from the staging's
state with the draws of sweep 0.

For each timed case it prints one JSON line: the median and spread of the
CUDA-event times of one wrapper call, the device time and device
operations a call (torch.profiler over the same calls), the wrapper's
median host time (the call returns after the launch); K6 also the steps
and the event and device microseconds a step, K7 the applied moves and the
proposals. The phases case prints each phase's median over the launches in
microseconds (K6: thread 0's sum over the steps and per step; K7: each
phase's longest position, and the sweep's device span from the first
block's start to the last block's end), with the SM clock the stamps
imply; a tree without the stamps says so. The card's name and power limit
come first. The generated fleets are cached (pickled) under this
checkout's fleetflow_tpu_torch/_ext_build/fleets/, so the XL fleet is made
once for all the trees.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 30
CASES = ("k6", "k7", "k7-sharded", "phases")
SLOTS = 12      # FF_PHASE_SLOTS in csrc/common.cuh
ROWS = 8192     # stamp rows: K7's positions, its old apply and reduce blocks
SHARDED_SHAPE = (9_997, 1_000)
XL_SHAPE = (29_997, 3_000)
WARM_T0, WARM_T1, STEPS, LADDER = 0.1, 1e-3, 64, 1.3
# K6's stamp slots: the four phases of a step, then the fetch's parts
K6_SLOTS = {3: "fetch", 4: "score", 5: "reduce", 6: "commit", 9: "rows",
            10: "elig_wait", 11: "staging"}
FLEETS = Path(__file__).resolve().parents[1] / "_ext_build" / "fleets"


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


def profile_calls(torch, fn, setup, reps: int) -> tuple:
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


def cached_fleet(lower, name: str, make):
    """The fleet `name`, made by make(lower) once and pickled for the
    other trees' interpreters."""
    path = FLEETS / f"{name}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    pt = make(lower)
    FLEETS.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(pt, f)
    os.replace(tmp, path)
    return pt


def sharded_fleet(lower, shape):
    return lower.synthetic_problem(*shape, seed=0, n_tenants=8,
                                   port_fraction=0.2, volume_fraction=0.1)


class Tree:
    """One checkout's modules and the device."""

    def __init__(self, tree: str, device: str = "cuda:0"):
        import numpy as np
        import torch

        from fleetflow_tpu_torch.lower import tensors as lower
        from fleetflow_tpu_torch.solver import (anneal, buckets, greedy,
                                                problem, sharded)
        self.np, self.torch, self.lower = np, torch, lower
        self.anneal, self.buckets, self.greedy = anneal, buckets, greedy
        self.problem, self.sharded = problem, sharded
        self.tree = tree
        self.dev = torch.device(device)


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


# -- K6 ------------------------------------------------------------------------

def k6_inputs(t: Tree) -> list:
    """[(label, problem, order)] of chip_smoke's [k6_scan] cases and the
    512 x 3,000 case."""
    np, lower = t.np, t.lower
    out = []

    def add(label, pt):
        prob = t.problem.prepare_problem(pt, t.dev)
        order = t.greedy.placement_order(pt.demand, pt.dep_depth,
                                         t.problem.unify_conflict_ids(pt))
        out.append((label, prob, t.torch.tensor(order, dtype=t.torch.int32,
                                                device=t.dev)))

    add("k6 10000x1000 spread", cached_fleet(
        lower, "10000x1000", lambda lw: sharded_fleet(lw, (10_000, 1_000))))
    for strategy in ("pack_into_dedicated", "fill_lowest", "best_effort"):
        pt = lower.synthetic_problem(
            2000, 200, seed=1, n_tenants=3,
            strategy=lower.PlacementStrategy(
                "spread_across_pool" if strategy == "best_effort"
                else strategy))
        if strategy == "best_effort":
            pt = dataclasses.replace(pt, capacity=(
                pt.capacity * np.float32(0.45)).astype(np.float32))
        add(f"k6 2000x200 {strategy}", pt)
    pt = lower.synthetic_problem(512, 3000, seed=2, n_tenants=3)
    pref = np.random.default_rng(2).random((512, 3000)).astype(np.float32)
    add("k6 512x3000 spread preferred",
        dataclasses.replace(pt, preferred=pref * np.float32(0.5)))
    return out


def k6_cases(t: Tree) -> None:
    torch, greedy = t.torch, t.greedy
    for label, prob, order in k6_inputs(t):
        def fn(prob=prob, order=order):
            greedy.greedy_place(prob, order)

        setup = tuple
        reps = 5 if prob.S * prob.N >= 10_000_000 else 20
        times = _event_ms(torch, fn, setup, reps)
        split = profile_calls(torch, fn, setup, reps)
        steps = order.shape[0]
        row(t.tree, label, times, split, steps=steps, N=prob.N,
            us_per_step=statistics.median(times) * 1e3 / steps,
            device_us_per_step=split[0] * 1e3 / steps)


# -- K7 ------------------------------------------------------------------------

def k7_stagings(t: Tree, which: str) -> list:
    """[(label, problem, (S,) state assignment, R, D)] of [k7]
    ("k7") or [sharded] ("k7-sharded")."""
    np, torch, sharded, buckets = t.np, t.torch, t.sharded, t.buckets
    pt = cached_fleet(t.lower, "9997x1000",
                      lambda lw: sharded_fleet(lw, SHARDED_SHAPE))
    out = []
    if which == "k7":
        rng = np.random.default_rng(7)
        valid = pt.node_valid.copy()
        valid[rng.choice(pt.N, int(0.05 * pt.N), replace=False)] = False
        for R, D in ((1, 8), (2, 4)):
            prob = t.problem.prepare_problem(pt, t.dev)
            prob, orig = buckets.pad_problem(prob, D)
            prob = dataclasses.replace(
                prob, n_real=orig, node_valid=torch.tensor(valid,
                                                           device=t.dev))
            seed = buckets.pad_assignment(t.greedy.partitioned_seed(pt, D),
                                          prob.S, valid)
            out.append((f"k7 {R}x{D}", prob,
                        torch.tensor(seed, device=t.dev), R, D))
        return out
    from fleetflow_tpu_torch.solver.resident import ProblemDelta
    positions = [t.dev] * 8

    def cold(pt_now, mesh, seed=0):
        rp = sharded.ShardedResident(pt_now, mesh=mesh)
        res = sharded.solve_sharded(pt_now, resident=rp, steps=64, block=4,
                                    seed=seed)
        return rp, res

    rp, _ = cold(pt, sharded.Mesh(positions, (sharded.SVC_AXIS,)))
    out.append(("k7 sharded cold_1x8", rp.prob, rp.assignment, 1, 8))
    rp, res = cold(pt, sharded.tempering_mesh(2, 4, devices=positions), 70)
    valid = pt.node_valid.copy()
    load = np.bincount(res.assignment, minlength=pt.N)
    load[~valid] = -1
    valid[int(load.argmax())] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy()))
    sharded.solve_sharded(cur, resident=rp, resident_warm=True, steps=64,
                          block=4, seed=71)
    out.append(("k7 sharded resident_2x4", rp.prob, rp.assignment, 2, 4))
    pt_xl = cached_fleet(t.lower, "29997x3000",
                         lambda lw: sharded_fleet(lw, XL_SHAPE))
    rp, _ = cold(pt_xl, sharded.Mesh(positions, (sharded.SVC_AXIS,)))
    out.append(("k7 sharded xl_cold_1x8", rp.prob, rp.assignment, 1, 8))
    return out


def k7_sweeps(t: Tree, prob, seed, R: int, D: int) -> list:
    """[(temperature label, fn, setup, base state, draws, temps)]: one
    sweep at the warm schedule's start and end, as the tree's loop
    launches it, from a fresh copy of the staging's state each call."""
    torch, sharded, anneal = t.torch, t.sharded, t.anneal
    base = anneal.chain_states_from_assignment(
        prob, seed.to(torch.int32).reshape(1, prob.S).expand(R, prob.S))
    M = max(8, min(256, (prob.S // D) // 2))
    gen = torch.Generator(device=t.dev)
    gen.manual_seed(11)
    draws = sharded.TorchDraws(gen).proposals(
        0, sharded._hot(prob, base, D), prob.N, M)
    sched = sharded._Schedule(WARM_T0, WARM_T1, STEPS, LADDER, R, True)
    out = []
    for label, i in (("t0", 0), ("t1", STEPS - 1)):
        temps = sched.temps(i)
        if hasattr(sharded, "sweep_launcher"):
            def setup(base=base):
                return (sharded.sweep_launcher(prob, base.clone(), D, M),)

            def fn(sweep, temps=temps):
                sweep(*draws, temps)
        else:
            scratch = sharded._scratch(R, D, M, prob.N, t.dev)

            def setup(base=base):
                return (base.clone(),)

            def fn(st, temps=temps, scratch=scratch):
                sharded.sharded_step_apply(prob, st, *draws, temps, scratch)
        out.append((label, fn, setup, base, draws, temps))
    return out


def k7_cases(t: Tree, which: str) -> None:
    torch, sharded = t.torch, t.sharded
    for label, prob, seed, R, D in k7_stagings(t, which):
        for tl, fn, setup, base, draws, temps in k7_sweeps(t, prob, seed, R,
                                                           D):
            _, applied = sharded.sharded_step_apply(prob, base.clone(),
                                                    *draws, temps)
            row(t.tree, f"{label} T={tl}", _event_ms(torch, fn, setup, REPS),
                profile_calls(torch, fn, setup, 20), temps=temps,
                applied=int(applied.sum()), proposals=int(draws[0].numel()),
                S=prob.S, N=prob.N)


# -- phases --------------------------------------------------------------------

def phases_case(t: Tree) -> None:
    """The stamped kernels' phase split (see the module docstring)."""
    import ctypes

    from fleetflow_tpu_torch import _ext
    torch, np = t.torch, t.np
    libs = [_ext.library(k) for k in ("k6_greedy_scan", "k7_sharded_sweep")]
    if not all(hasattr(lib, "ff_set_phases") for lib in libs):
        print(json.dumps({"tree": t.tree, "case": "phases",
                          "stamps": False}), flush=True)
        return
    buf = torch.zeros((ROWS, SLOTS), dtype=torch.int64, device=t.dev)
    for lib in libs:
        if lib.ff_set_phases(ctypes.c_void_p(buf.data_ptr())) != 0:
            raise RuntimeError("cannot set the phase buffer")

    def stamped(fn, setup, reps: int) -> np.ndarray:
        rows = []
        for _ in range(reps):
            args = setup()
            buf.zero_()
            fn(*args)
            torch.cuda.synchronize()
            rows.append(buf.cpu().numpy().astype(np.float64))
        return np.stack(rows)            # (reps, ROWS, SLOTS)

    def ns_per_cycle(r: np.ndarray) -> float:
        live = r[..., 2] > 0
        return float((r[..., 1] - r[..., 0])[live].sum() / r[..., 2][live].sum())

    for label, prob, order in k6_inputs(t):
        reps = 3 if prob.S * prob.N >= 10_000_000 else 10
        r = stamped(lambda: t.greedy.greedy_place(prob, order), tuple,
                    reps)[:, 0]
        k = ns_per_cycle(r) / 1e3        # us a cycle
        steps = r[:, 7]
        out = {"tree": t.tree, "case": f"phases {label}",
               "sm_mhz": 1e-3 / k, "steps": float(np.median(steps)),
               "block_us": float(np.median(r[:, 2] * k))}
        for slot, name in K6_SLOTS.items():
            out[f"{name}_us"] = float(np.median(r[:, slot] * k))
            out[f"{name}_us_per_step"] = float(np.median(
                r[:, slot] * k / np.maximum(steps, 1)))
        print(json.dumps(out), flush=True)

    names = {3: "delta", 4: "winner_scan", 5: "election",
             9: "integer_apply", 10: "float_walk",
             6: "float_walk_longest_thread", 11: "reduce"}
    for label, prob, seed, R, D in k7_stagings(t, "k7"):
        for tl, fn, setup, _base, _draws, _temps in k7_sweeps(t, prob, seed,
                                                              R, D):
            r = stamped(fn, setup, REPS)
            k = ns_per_cycle(r) / 1e3
            live = r[..., 2] > 0
            start = np.where(live, r[..., 0], np.inf).min(1)
            end = np.where(live, r[..., 1], 0).max(1)
            out = {"tree": t.tree, "case": f"phases {label} T={tl}",
                   "sm_mhz": 1e-3 / k,
                   "span_us": float(np.median(end - start) / 1e3),
                   "applied": float(np.median(r[..., 7].sum(1)))}
            for slot, name in names.items():
                if r[..., slot].any():
                    out[f"{name}_us"] = float(np.median(
                        r[..., slot].max(1) * k))
            print(json.dumps(out), flush=True)


def child(tree: str, cases, phases: bool) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from fleetflow_tpu_torch import _ext
    if phases:
        # a build of its own (the flags are part of the build's hash)
        _ext.NVCC_FLAGS = (*_ext.NVCC_FLAGS, "-DK6_PHASES", "-DK7_PHASES")
    _ext.build()
    t = Tree(tree)
    t.torch.use_deterministic_algorithms(False)
    if phases:
        phases_case(t)
        return
    if "k6" in cases:
        k6_cases(t)
    for which in ("k7", "k7-sharded"):
        if which in cases:
            k7_cases(t, which)


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
                capture_output=True, text=True, timeout=1200)
            print(run.stdout, end="", flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
