"""Time K4 (the batched greedy seed) and K3 (the exact rebuild) of several
checkouts of fleetflow_tpu_torch on one card, at the shapes the main path
gives them, and split each call into its device work.

    python3 fleetflow_tpu_torch/tools/k34_profile.py [--cases LIST] \
        TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and measures, on inputs made the same way in every tree,
the cases of LIST (comma-separated names; default all of them):

  k4        the seed of chip_smoke's 10k x 1k fleet on its placement
            order, and of the mux tier's first 2000x200 stage (bucketed)
  k3        2 chains (the K4 seed and a perturbed copy), with the stats,
            at 10k x 1k and on the 2000x200 staging
  k3-lanes  the lane check's 8 stacked 2000x200 stages x 2 chains, stats
  k3-xl     the 29,997 x 3,000 fleet on its bucketed staging, one chain
            (the partitioned host seed), with the stats
  solve     GpuSolverScheduler(bucket=False).place of the 10k x 1k fleet,
            end to end (staging, K4, the refine, the gate)

For each kernel case it prints one JSON line: the median and spread of the
CUDA-event times of one wrapper call (host work included), and, from
torch.profiler
over the same calls, the device time per call (kernels and memsets summed),
the device operations (launches) per call, and that split by kernel name;
for the solve, the median and spread of its host wall time (ending in a
device sync). The card's name and power limit come first. chip_smoke.py runs it on its
own checkout for its device-only numbers: a fresh interpreter, because a
profiler session late in a long process has lost kernel records.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS = 20
CASES = ("k4", "k3", "k3-lanes", "k3-xl", "solve")


def _event_ms(torch, fn, reps: int) -> list:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def _device_split(torch, fn, reps: int) -> tuple:
    """(device ms a call, device operations a call, {name: [ms, n] a
    call}) of `reps` calls of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        by_name[ev.key[:60]] = [us / 1e3 / reps, ev.count / reps]
    dev_ms = sum(v[0] for v in by_name.values())
    ops = sum(v[1] for v in by_name.values())
    return dev_ms, ops, by_name


def child(tree: str, cases=CASES) -> list:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.solver import buckets, greedy, kernels, problem

    dev = torch.device("cuda", 0)
    _ext.build()
    out = []

    def measure(label, fn, reps=REPS):
        times = _event_ms(torch, fn, reps)
        dev_ms, ops, by_name = _device_split(torch, fn, min(reps, 10))
        row = {"tree": tree, "case": label,
               "event_ms_median": statistics.median(times),
               "event_ms_min": times[0], "event_ms_max": times[-1],
               "device_ms": dev_ms, "device_ops_per_call": ops,
               "by_name": by_name}
        print(json.dumps(row), flush=True)
        out.append(row)

    def order_of(pt, prob):
        order = np.concatenate([
            greedy.placement_order(pt.demand, pt.dep_depth,
                                   problem.unify_conflict_ids(pt)),
            np.arange(pt.S, prob.S, dtype=np.int32)])
        return torch.tensor(order, dtype=torch.int32, device=dev)

    # K4 at 10k x 1k (exact shapes) and on the 2000x200 mux tier
    pt = lower.synthetic_problem(10_000, 1_000, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    prob = problem.prepare_problem(pt, dev)
    order = order_of(pt, prob)
    seed = greedy.greedy_place_batched(prob, order)
    fleet = cs.mux_fleets(lower)
    pt2 = fleet(2000, 200, 0)
    prob2, _ = buckets.stage_problem_tiers(pt2, device=dev)
    order2 = order_of(pt2, prob2)
    if "k4" in cases:
        measure("k4 10000x1000",
                lambda: greedy.greedy_place_batched(prob, order))
        measure("k4 2000x200",
                lambda: greedy.greedy_place_batched(prob2, order2))

    # K3 at 10k x 1k: the seed and a perturbed copy, as chip_smoke's check
    rng = np.random.default_rng(0)
    pert = seed.clone()
    heavy = torch.tensor(rng.choice(prob.S, prob.S // 3, replace=False),
                         device=dev)
    pert[heavy] = torch.tensor(rng.integers(0, 10, heavy.numel()),
                               dtype=torch.int32, device=dev)
    both = torch.stack([seed, pert])
    if "k3" in cases:
        measure("k3 10000x1000 C=2", lambda: kernels.k3_rebuild(
            prob, both, with_stats=True))

    # K3 on the 2000x200 tier's seed and a perturbed copy
    seed2 = greedy.greedy_place_batched(prob2, order2)
    pert2 = seed2.clone()
    heavy2 = torch.tensor(rng.choice(prob2.S, prob2.S // 3, replace=False),
                          device=dev)
    pert2[heavy2] = torch.tensor(rng.integers(0, 10, heavy2.numel()),
                                 dtype=torch.int32, device=dev)
    both2 = torch.stack([seed2, pert2])
    if "k3" in cases:
        measure("k3 2000x200 C=2", lambda: kernels.k3_rebuild(
            prob2, both2, with_stats=True))
    if "k3-lanes" in cases:
        lanes_case(torch, np, cs, problem, buckets, kernels, fleet, rng, dev,
                   measure)
    if "k3-xl" in cases:
        xl_case(torch, cs, lower, buckets, greedy, kernels, dev, measure)
    if "solve" in cases:
        out.append(solve_case(torch, pt, tree))
    return out


def lanes_case(torch, np, cs, problem, buckets, kernels, fleet, rng, dev,
               measure) -> None:
    """K3 with 8 lanes of 2000x200, 2 chains a lane (chip_smoke's
    [lanes])."""
    lprob, _solo, seeds = cs.lane_problems(
        np, torch, problem, buckets, [fleet(2000, 200, i) for i in range(8)],
        dev)
    L, S = seeds.shape
    lpert = seeds.clone()
    cols = torch.tensor(rng.choice(S, S // 3, replace=False), device=dev)
    lpert[:, cols] = torch.tensor(rng.integers(0, 10, (L, cols.numel())),
                                  dtype=torch.int32, device=dev)
    lboth = torch.stack([seeds, lpert], 1).contiguous()
    measure("k3 2000x200 L=8 C=2", lambda: kernels.k3_rebuild(
        lprob, lboth, with_stats=True))


def xl_case(torch, cs, lower, buckets, greedy, kernels, dev,
            measure) -> None:
    """K3 on the XL staging, one chain from the partitioned host seed."""
    ptx = cs.sharded_fleet(lower, cs.XL_SHAPE)
    probx, _ = buckets.stage_problem_tiers(ptx, device=dev)
    seedx = buckets.pad_assignment(greedy.partitioned_seed(ptx, 8), probx.S,
                                   ptx.node_valid)
    ax = torch.tensor(seedx, dtype=torch.int32, device=dev)[None]
    measure(f"k3 XL {probx.S}x{probx.N} G={probx.G} C=1",
            lambda: kernels.k3_rebuild(probx, ax, with_stats=True), reps=10)


def solve_case(torch, pt, tree: str) -> dict:
    """The cold solve end to end, a fresh scheduler each time."""
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    walls = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        GpuSolverScheduler(bucket=False).place(pt)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    row = {"tree": tree, "case": "solve cold 10000x1000",
           "wall_ms_median": statistics.median(walls),
           "wall_ms_min": walls[0], "wall_ms_max": walls[-1]}
    print(json.dumps(row), flush=True)
    return row


def main(argv: list[str]) -> int:
    cases = CASES
    if argv[:1] == ["--cases"]:
        cases = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(cases) <= set(CASES):
            print(f"unknown case in {cases}; the cases: {CASES}",
                  file=sys.stderr)
            return 2
    if argv[:1] == ["--child"]:
        child(argv[1], cases)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    rc = 0
    for tree in argv:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--cases", ",".join(cases), "--child", tree],
                             capture_output=True,
                             text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
