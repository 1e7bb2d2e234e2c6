"""Time K5 (the sub-solve's stage and commit) of several checkouts of
fleetflow_tpu_torch on one card, with what the sub-solve does around it.

    python3 fleetflow_tpu_torch/tools/k5_profile.py [--cases LIST] \
        TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and measures, on inputs made the same way in every tree,
the cases of LIST (comma-separated names; default both):

  stage   a sub-solve's way from the churn to the mini problem, at mini
          tiers 256, 512, 1024 and 4096 of chip_smoke's [default] fleet
          (10,000 services and a 200-row inert tenant stage, 1,000 nodes,
          bucketed to 10,848 rows), the plan's closure grown from pending
          rows until it fills half the tier or more: the host planner
          (``plan_active``), the plan's uploads (``stage_subsolve``) and
          the kernel. A tree whose planner builds the frozen base on the
          host (its plan carries ``load0``) uploads seven arrays and
          launches ``k5_gather``; a tree whose K5 builds it uploads one
          buffer and launches ``k5_stage``.
  commit  ``k5_commit`` of 2 chains at each tier's plan.
  phases  the stage at each tier, the tree's kernels built with
          -DK5_PHASES: each block's stamps by role (block 0, slot
          blocks, node blocks): its start after the launch's first, its
          span, and its setup, tile scan and last step (block 0: the
          closure rows; node blocks: the last flush), its staging of and
          wait for assignment tiles and its scan work in them (block 0:
          the domain counts; node blocks: the ballots), the longest block
          of each role; and the launch's device span. A tree without the
          stamps says so.
  ab      chip_smoke's [default] bursts end to end, sub-solve on: one
          drive on a fresh GpuSolverScheduler() picks the node masks
          (their digest printed, so two trees can be seen to replay the
          same ones), then REPLAYS more drives replay them; every solve
          held to chip_smoke's contract.

For each (case, tier) of stage and commit it prints one JSON line: the
median and spread of the CUDA-event times of the device part (uploads and
kernel), the device time a call (torch.profiler over the same calls:
kernels and copies, and the kernels alone), the median host ms of the
planner, of the device part's calls and of the kernel's wrapper alone,
and the uploads a call with their bytes. The card's
name and power limit come first. chip_smoke.py runs it on its own
checkout for K5's device ms: a fresh interpreter, because a profiler
session late in a long process has lost kernel records. For ab it prints
a line a replay: each burst's wall ms, plan_ms, subsolve_ms and outcome,
and the bursts' sum.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS = 20
REPLAYS = 2
CASES = ("stage", "commit", "phases", "ab")
SLOTS = 12      # FF_PHASE_SLOTS in csrc/common.cuh
ROWS = 4096     # stamp rows: the stage's blocks
ROLES = ("block0", "slot", "node")
TIERS = (256, 512, 1024, 4096)


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


def _host_ms(torch, fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _device_ms(torch, fn, reps: int) -> tuple:
    """(device ms a call, kernel device ms a call, device operations a
    call) of `reps` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = kern = 0.0
    ops = 0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        total += us
        ops += ev.count
        if "k5_" in ev.key:
            kern += us
    return total / 1e3 / reps, kern / 1e3 / reps, ops / reps


def plans(np, torch, tree_mods, dev) -> list:
    """[(tier, plan, resident, mirror, index, pending, cfg)] on the [default]
    fleet: every real row on a random eligible valid node (none stranded),
    the pending rows the first m of a fixed permutation, m the least whose
    closure fills more than half of the tier."""
    chip_smoke, lower, subsolve, ResidentProblem, pad_assignment = tree_mods
    pt, _tenant = chip_smoke.default_fleet(np, lower)
    rp = ResidentProblem(pt, dev)
    rng = np.random.default_rng(0)
    ok = pt.eligible & pt.node_valid[None, :]
    real = np.argmax(rng.random(ok.shape) * ok, axis=1).astype(np.int32)
    padded = pad_assignment(real, rp.prob.S, pt.node_valid)
    rp.assignment = torch.tensor(padded, dtype=torch.int32, device=dev)
    index = subsolve.ActiveIndex(pt)
    cfg = subsolve.SubsolveConfig(enabled=True, frac=1.0, min_tier=256,
                                  max_tier=4096)
    perm = rng.permutation(chip_smoke.N_SERVICES)
    out = []
    for tier in TIERS:
        lo, hi = 1, perm.size
        while lo < hi:               # the least m whose closure > tier / 2
            m = (lo + hi) // 2
            if index.closure(perm[:m]).size > tier // 2:
                hi = m
            else:
                lo = m + 1
        pending = np.sort(perm[:lo])
        plan, outcome = subsolve.plan_active(
            index, pt, padded, rp.prob.S, rp.prob.T, pending, cfg,
            G_full=rp.prob.G, Gc_full=rp.prob.Gc)
        if plan is None or plan.tier != tier:
            raise RuntimeError(f"tier {tier}: {outcome}, "
                               f"{None if plan is None else plan.tier}")
        out.append((tier, plan, rp, padded, index, pending, cfg))
    return out


def ab_case(np, tree: str, chip_smoke, mods, dev_name: str) -> None:
    """The [default] bursts, sub-solve on: one drive picks the masks,
    REPLAYS drives replay them."""
    import hashlib
    GpuSolverScheduler, ProblemDelta, verify, _ext, subsolve, lower = mods
    pt0, tenant = chip_smoke.default_fleet(np, lower)
    index = subsolve.ActiveIndex(pt0)
    masks = None
    for i in range(REPLAYS + 1):
        sched = GpuSolverScheduler()
        record = chip_smoke.make_record(sched, verify, _ext, dev_name,
                                        "ab", echo=False)
        rows, _pt, _valid, drawn = chip_smoke.drive_default(
            np, pt0, sched, ProblemDelta, record, index,
            chip_smoke.N_SERVICES, tenant, replay=masks)
        if masks is None:
            masks = drawn
            digest = hashlib.sha256(np.stack(masks).tobytes()).hexdigest()
            continue
        bursts = rows[1:]
        print(json.dumps({
            "tree": tree, "case": f"ab replay={i}", "masks": digest[:16],
            "sum_ms": sum(r["ms"] for r in bursts),
            "plan_ms_sum": sum(r["timings_ms"].get("plan_ms", 0.0)
                               for r in bursts),
            "subsolve_ms_sum": sum(r["timings_ms"].get("subsolve_ms", 0.0)
                                   for r in bursts),
            "bursts": [{"solve": r["solve"], "ms": r["ms"],
                        "plan_ms": r["timings_ms"].get("plan_ms"),
                        "subsolve_ms": r["timings_ms"].get("subsolve_ms"),
                        "outcome": (r.get("subsolve") or {}).get("outcome"),
                        "sweeps": r["sweeps"]} for r in bursts]}),
            flush=True)


def phases_case(np, torch, tree: str, tier: int, plan, rp, subsolve,
                _ext) -> None:
    """The stamped stage's blocks by role (see the module docstring)."""
    import ctypes
    lib = _ext.library("k5_subsolve")
    if not hasattr(lib, "ff_set_phases"):
        print(json.dumps({"tree": tree, "case": "phases", "stamps": False}),
              flush=True)
        return
    buf = torch.zeros((ROWS, SLOTS), dtype=torch.int64, device=rp.device)
    if lib.ff_set_phases(ctypes.c_void_p(buf.data_ptr())) != 0:
        raise RuntimeError("cannot set the phase buffer")
    staged = subsolve.stage_subsolve(rp, plan)
    reps = []
    for _ in range(REPS):
        buf.zero_()
        subsolve.k5_stage(rp.prob, rp.assignment, staged, plan)
        torch.cuda.synchronize()
        reps.append(buf.cpu().numpy().astype(np.float64))
    r = np.stack(reps)                      # (reps, ROWS, SLOTS)
    live = r[..., 2] > 0
    ns_cycle = float((r[..., 1] - r[..., 0])[live].sum()
                     / r[..., 2][live].sum())
    start = np.where(live, r[..., 0], np.inf).min(1)
    end = np.where(live, r[..., 1], 0).max(1)
    out = {"tree": tree, "case": f"phases tier={tier}",
           "sm_mhz": 1e3 / ns_cycle,
           "span_us": float(np.median(end - start)) / 1e3}
    for code, role in enumerate(ROLES):
        sel = live & (r[..., 3] == code)
        if not sel.any():
            continue
        rel = np.where(sel, (r[..., 0] - start[:, None]) / 1e3, np.nan)
        dur = np.where(sel, (r[..., 1] - r[..., 0]) / 1e3, np.nan)
        cyc = {k: np.where(sel, r[..., s] * ns_cycle / 1e3, np.nan)
               for k, s in (("setup", 4), ("scan", 5), ("last", 6),
                            ("tile_wait", 7), ("tile_part", 8))}
        out[role] = {
            "blocks": int(sel[0].sum()),
            "latest_start_us": float(np.median(np.nanmax(rel, 1))),
            "longest_us": float(np.median(np.nanmax(dur, 1))),
            **{f"{k}_us": float(np.median(np.nanmax(v, 1)))
               for k, v in cyc.items()}}
    print(json.dumps(out), flush=True)
    lib.ff_set_phases(ctypes.c_void_p(0))


def child(tree: str, cases) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.solver import subsolve
    from fleetflow_tpu_torch.solver.buckets import pad_assignment
    from fleetflow_tpu_torch.solver.resident import ResidentProblem
    if "phases" in cases:
        # a build of its own (the flags are part of the build's hash)
        _ext.NVCC_FLAGS = (*_ext.NVCC_FLAGS, "-DK5_PHASES")
    _ext.build()
    torch.use_deterministic_algorithms(False)
    dev = torch.device("cuda", 0)
    lean = hasattr(subsolve, "k5_stage")
    if "ab" in cases:
        from fleetflow_tpu_torch.sched import GpuSolverScheduler
        from fleetflow_tpu_torch.solver.repair import verify
        from fleetflow_tpu_torch.solver.resident import ProblemDelta
        ab_case(np, tree, chip_smoke, (GpuSolverScheduler, ProblemDelta,
                                       verify, _ext, subsolve, lower),
                str(dev))
        if not {"stage", "commit"} & set(cases):
            return
    for tier, plan, rp, mirror, index, pending, cfg in plans(
            np, torch, (chip_smoke, lower, subsolve, ResidentProblem,
                        pad_assignment), dev):
        prob, a = rp.prob, rp.assignment
        sizes = []
        real_upload = rp.upload

        def counted(arr, dtype):
            sizes.append(np.asarray(arr).nbytes)
            return real_upload(arr, dtype)

        rp.upload = counted
        staged = subsolve.stage_subsolve(rp, plan)
        uploads, upload_bytes = len(sizes), sum(sizes)

        def device_part():
            st = subsolve.stage_subsolve(rp, plan)
            if lean:
                return subsolve.k5_stage(prob, a, st, plan)
            return subsolve.k5_gather(prob, a, st[0], plan.n_sub)

        def kernel_only():
            if lean:
                return subsolve.k5_stage(prob, a, staged, plan)
            return subsolve.k5_gather(prob, a, staged[0], plan.n_sub)

        def planner():
            subsolve.plan_active(index, rp.pt, mirror, prob.S, prob.T,
                                 pending, cfg, G_full=prob.G,
                                 Gc_full=prob.Gc)

        rows = staged[:plan.tier] if lean else staged[0]
        if "phases" in cases:
            if lean:
                phases_case(np, torch, tree, tier, plan, rp, subsolve, _ext)
            else:
                print(json.dumps({"tree": tree, "case": "phases",
                                  "stamps": False}), flush=True)
        if "stage" in cases:
            times = _event_ms(torch, device_part, REPS)
            dev_ms, kern_ms, ops = _device_ms(torch, device_part, REPS)
            print(json.dumps({
                "tree": tree, "case": f"stage tier={tier}",
                "route": "k5_stage" if lean else "host base + k5_gather",
                "n_sub": plan.n_sub, "G_sub": plan.G_sub,
                "event_ms_median": statistics.median(times),
                "event_ms_min": times[0], "event_ms_max": times[-1],
                "device_ms": dev_ms, "kernel_device_ms": kern_ms,
                "device_ops_per_call": ops,
                "host_ms_median": _host_ms(torch, device_part, REPS),
                "kernel_host_ms_median": _host_ms(torch, kernel_only, REPS),
                "plan_ms_median": _host_ms(torch, planner, 5),
                "uploads": uploads, "upload_bytes": upload_bytes}),
                flush=True)
        if "commit" in cases:
            seed = (subsolve.k5_stage(prob, a, staged, plan).seed if lean
                    else subsolve.k5_gather(prob, a, rows, plan.n_sub)[3])
            chain1 = seed.clone()
            chain1[:plan.n_sub] = (chain1[:plan.n_sub] + 1) % prob.N
            best = torch.stack([seed, chain1])
            viol = torch.zeros(2, device=dev)
            soft = torch.tensor([0.5, 0.25], device=dev)

            def commit():
                subsolve.k5_commit(best, viol, soft, rows, a)

            times = _event_ms(torch, commit, REPS)
            dev_ms, kern_ms, ops = _device_ms(torch, commit, REPS)
            print(json.dumps({
                "tree": tree, "case": f"commit tier={tier}",
                "n_sub": plan.n_sub,
                "event_ms_median": statistics.median(times),
                "event_ms_min": times[0], "event_ms_max": times[-1],
                "device_ms": dev_ms, "kernel_device_ms": kern_ms,
                "device_ops_per_call": ops,
                "host_ms_median": _host_ms(torch, commit, REPS)}),
                flush=True)
        rp.upload = real_upload


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
    # the stamped build is a build of its own: phases run apart
    groups = [g for g in ([c for c in cases if c != "phases"],
                          ["phases"] if "phases" in cases else []) if g]
    rc = 0
    for tree in argv:
        for group in groups:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cases",
                 ",".join(group), "--child", tree],
                capture_output=True, text=True, timeout=1200)
            print(run.stdout, end="", flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
