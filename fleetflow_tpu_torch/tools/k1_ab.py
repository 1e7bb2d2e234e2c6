"""Time the solo K1 sweep of several checkouts of fleetflow_tpu_torch on one
card, to see whether a change to the kernel costs the solo path anything.

    python3 fleetflow_tpu_torch/tools/k1_ab.py TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and times one K1 sweep of the 10k x 1k fleet chip_smoke's
K1 check uses: two chains (the greedy seed and a perturbed copy), the
card's 256 proposals a chain, T = 1, the state cloned outside the timed
region. It prints the card's name and power limit, then one JSON line per
run: the median and the spread of the CUDA-event times (the wrapper's
host work included: the card idles until the launch), and the same
launches split into the kernel's mean device time (torch.profiler) and
the wrapper's median host time.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS = 200


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.solver import anneal, greedy, problem

    dev = torch.device("cuda", 0)
    _ext.build()
    pt = lower.synthetic_problem(10_000, 1_000, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    prob = problem.prepare_problem(pt, dev)
    order = torch.tensor(greedy.placement_order(
        pt.demand, pt.dep_depth, problem.unify_conflict_ids(pt)),
        dtype=torch.int32, device=dev)
    seed = greedy.greedy_place_batched(prob, order)
    rng = np.random.default_rng(0)
    pert = seed.clone()
    heavy = torch.tensor(rng.choice(prob.S, prob.S // 3, replace=False),
                         device=dev)
    pert[heavy] = torch.tensor(rng.integers(0, 10, heavy.numel()),
                               dtype=torch.int32, device=dev)
    ports = torch.tensor(np.flatnonzero((pt.port_ids >= 0).any(1)),
                         device=dev)
    pert[ports] = 0
    base = anneal.chain_states_from_assignment(prob,
                                               torch.stack([seed, pert]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    M = anneal.default_proposals_per_step(prob.S)
    s_idx, b_idx, u = anneal.draw_proposals(prob, base, gen, M)
    times = []
    for i in range(REPS + 5):
        st = base.clone()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        anneal.batched_step_apply(prob, st, s_idx, b_idx, u, 1.0)
        end.record()
        end.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    times.sort()

    # the same launches split: the wrapper's host time (the call returns
    # after the launch, before the kernel ends) and, under torch.profiler,
    # the kernel's own device time
    from torch.profiler import ProfilerActivity, profile
    states = [base.clone() for _ in range(REPS)]
    host = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for st in states:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            anneal.batched_step_apply(prob, st, s_idx, b_idx, u, 1.0)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    dev_us, launches = 0.0, 0
    for ev in prof.key_averages():
        if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                and "k1_sweep" in ev.key):
            dev_us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
            launches += ev.count
    return {"tree": tree, "k1_ms_median": statistics.median(times),
            "k1_ms_p10": times[len(times) // 10],
            "k1_ms_p90": times[9 * len(times) // 10],
            "kernel_device_ms_mean": (dev_us / 1e3 / launches
                                      if launches else None),
            "profiled_launches": launches,
            "wrapper_host_ms_median": statistics.median(host),
            "reps": REPS, "chains": int(base.assignment.shape[0]),
            "proposals": M}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
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
                              "--child", tree], capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr, flush=True)
            rc = 1
            continue
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
