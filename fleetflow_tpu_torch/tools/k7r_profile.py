"""Time K7's three cross-rank entry points (elect, apply, reduce) of several
checkouts of fleetflow_tpu_torch on one card, as the rank loop launches
them, and split elect and apply into their phases.

    python3 fleetflow_tpu_torch/tools/k7r_profile.py [--cases LIST] \
        TREE_A TREE_B TREE_B TREE_A

Each argument is the root of a checkout; each runs in its own interpreter,
in the order given (A, B, B, A puts drift on both sides), builds that
tree's kernels and measures, on inputs made the same way in every tree,
the cases of LIST (comma-separated names; default all of them):

  anneal   [ranks]' cross-rank anneal: the sharded fleet (9,997 x 1,000)
           padded over 2 shards (9,998 rows), position (0, 0) of a 2x2
           mesh, its 4,999-row shard and the partitioned seed; M 256
  solve    solve_sharded over 2x2 ranks: the 10,848-row staging of a
           ShardedResident of the sharded fleet after a cold solve,
           position (0, 0), its 5,424-row shard; M 256
  m128     the solve staging at M 128 (solve_sharded's
           proposals_per_step=128)
  wide     the solve staging at M 2,048 (the widest the first design's
           bind takes)
  widest   the solve staging at the widest M the tree's bind takes
           (bisection over binds of [1, 32,768])
  phases   every case above once more, the tree's kernels built with
           -DK7R_PHASES: elect's and apply's own cycle stamps, per phase

A case binds one RankSweepLauncher (``sharded_ranks.rank_sweep``) on the
position's shard and its replica's state, as ``anneal_ranks`` does once a
call, and runs SWEEPS sweeps through it: each sweep draws the position's
proposals (``sharded.TorchDraws``, its hot mask from the current state),
then elect, apply, and reduce with the position's own partial in shard
order beside zeros and its own integer deltas (the collectives of a rank
whose other shards moved nothing). Each entry point is timed on an idle
card (a synchronize before it, as after a gloo collective): the CUDA-event
ms of the wrapper call and the wrapper's host ms; a second run of the same
sweeps under torch.profiler gives each kernel's device ms. One JSON line a
case and entry point: the medians and ranges, the device ms, the applied
moves and touched nodes a sweep. The phases case prints, per entry point,
each phase's median over the sweeps in microseconds (the longest block's
cycles at the SM clock the stamps imply) and the launch's device span from
the first block's start to the last block's end; a tree without the stamps
says so. The card's name and power limit come first. The sharded fleet is
made and pickled by each tree's tools/k67_profile.py (its
_ext_build/fleets/ cache, shared with that tool's runs).

``--device cpu`` rehearses a tree on the plain versions (no events, no
profiler, no stamps).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

SWEEPS = 40
CASES = ("anneal", "solve", "m128", "wide", "widest", "phases")
SLOTS = 12      # FF_PHASE_SLOTS in csrc/common.cuh
ROWS = 64       # stamp rows: one a block
SHARDED_SHAPE = (9_997, 1_000)
WIDEST_PROBE = 1 << 15
ENTRIES = ("k7_rank_elect", "k7_rank_apply", "k7_rank_reduce")
KERNEL_NAMES = {"k7_rank_elect": "k7r_elect", "k7_rank_apply": "k7r_apply",
                "k7_rank_reduce": "k7r_reduce"}


class Tree:
    """One checkout's modules and the device."""

    def __init__(self, tree: str, device: str):
        import numpy as np
        import torch

        from fleetflow_tpu_torch import _ext
        from fleetflow_tpu_torch.lower import tensors as lower
        from fleetflow_tpu_torch.solver import (anneal, buckets, greedy,
                                                problem, sharded,
                                                sharded_ranks)
        self.np, self.torch, self.lower, self._ext = np, torch, lower, _ext
        self.anneal, self.buckets, self.greedy = anneal, buckets, greedy
        self.problem, self.sharded, self.sr = problem, sharded, sharded_ranks
        self.tree = tree
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"


def stagings(t: Tree, cases) -> list:
    """[(case, whole padded problem, (S,) assignment, M)] of the cases."""
    from fleetflow_tpu_torch.tools.k67_profile import (cached_fleet,
                                                       sharded_fleet)
    torch, sharded = t.torch, t.sharded
    pt = cached_fleet(t.lower, "9997x1000",
                      lambda lw: sharded_fleet(lw, SHARDED_SHAPE))
    out = []
    if "anneal" in cases:
        prob, orig = t.buckets.pad_problem(
            t.problem.prepare_problem(pt, t.dev), 2)
        prob = dataclasses.replace(prob, n_real=orig)
        seed = torch.tensor(t.buckets.pad_assignment(
            t.greedy.partitioned_seed(pt, 2), prob.S, pt.node_valid),
            device=t.dev)
        out.append(("anneal", prob, seed, 256))
    rest = [c for c in ("solve", "m128", "wide", "widest") if c in cases]
    if rest:
        rp = sharded.ShardedResident(pt, mesh=sharded.tempering_mesh(
            2, 2, devices=[t.dev] * 4))
        sharded.solve_sharded(pt, resident=rp, steps=64, block=4, seed=0)
        prob, seed = rp.prob, rp.assignment.to(t.dev)
        for case in rest:
            M = {"solve": 256, "m128": 128, "wide": 2048}.get(case)
            out.append((case, prob, seed, M))
    return out


def position(t: Tree, prob, seed):
    """Position (0, 0) of a 2x2 mesh over `prob`: (its shard, its
    replica's state from the (S,) assignment `seed`, the position)."""
    torch, sr = t.torch, t.sr
    pos = sr.RankPosition(0, 0, 2, 2, prob.S, 0)
    whole = t.anneal.chain_states_from_assignment(
        prob, seed.to(torch.int32).reshape(1, -1).contiguous())
    st = t.anneal.ChainState(whole.assignment[:, :pos.S_loc].contiguous(),
                             *(x.contiguous() for x in whole[1:]))
    return sr.shard_rows(prob, pos), st, pos


class Sweeps:
    """One launcher bound once (``sharded_ranks.rank_sweep``) on a copy
    of the state `st` of shard `lp` at position `pos`, and each sweep's
    three entry points: the position's proposals drawn from the current
    state's hot mask (``sharded.TorchDraws``, seed 31), then elect, apply,
    and reduce with the position's own partial in shard order beside
    zeros and its own integer deltas (the collectives of a rank whose
    other shards moved nothing)."""

    def __init__(self, torch, sr, sharded, lp, st, pos, M: int):
        self.torch, self.sr, self.lp, self.pos, self.M = torch, sr, lp, pos, M
        dev = st.assignment.device
        self.st = type(st)(*(x.clone() for x in st))
        self.sweep = sr.rank_sweep(lp, self.st, pos, M)
        gen = torch.Generator(device=dev)
        gen.manual_seed(31)
        self.draws = sharded.TorchDraws(gen)
        self.zeros = torch.zeros((lp.N, 3), dtype=torch.float32, device=dev)
        self.hot = torch.zeros((pos.R, pos.D, lp.S), dtype=torch.bool,
                               device=dev)
        self.i = 0

    def calls(self):
        """[(entry point or None, thunk)] of the next sweep."""
        pos, sweep, sc = self.pos, self.sweep, self.sweep.scratch
        self.hot[pos.r, pos.d] = self.sr._hot(self.lp, self.st)[0]
        s, b, u = (x[pos.r, pos.d].contiguous() for x in
                   self.draws.proposals(self.i, self.hot, self.lp.N, self.M))
        temp = 0.1 * 0.9 ** (self.i % 32)
        self.i += 1
        gathered = []
        parts = [sc.partial if q == pos.d else self.zeros
                 for q in range(pos.D)]
        return [("k7_rank_elect", lambda: sweep.elect(s, b, u, temp)),
                ("k7_rank_apply", sweep.apply),
                (None, lambda: gathered.append(self.torch.stack(parts))),
                ("k7_rank_reduce", lambda: sweep.reduce(gathered[0]))]

    def counts(self):
        """(applied moves, touched nodes) of the sweep in flight."""
        sc = self.sweep.scratch
        return (int(sc.applied[0]),
                int((sc.deltas[-self.lp.N:] > 0).sum()))


def entry_times(torch, sr, sharded, lp, st, pos, M: int, sweeps: int,
                cuda: bool = True) -> dict:
    """Each cross-rank entry point as ``anneal_ranks`` launches it
    (:class:`Sweeps`), `sweeps` sweeps after two, each entry point on an
    idle card (a synchronize before it, as after a gloo collective):
    {entry: {"event": [ms], "host": [ms], "device_ms": ms a launch from
    torch.profiler over `sweeps` more, or None}, "applied": [...],
    "touched": [...]}. With `cuda` False (the plain versions on the CPU)
    no events and no device time."""
    run = Sweeps(torch, sr, sharded, lp, st, pos, M)
    out = {k: {"event": [], "host": [], "device_ms": None} for k in ENTRIES}
    out["applied"], out["touched"] = [], []
    for i in range(sweeps + 2):
        marks = []
        for name, fn in run.calls():
            if name == "k7_rank_reduce":
                counts = run.counts()
            if cuda:
                torch.cuda.synchronize()
            if name is None:
                fn()
                continue
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            h0 = time.perf_counter()
            fn()
            h1 = time.perf_counter()
            if cuda:
                e1.record()
                marks.append((name, e0, e1))
            if i >= 2:
                out[name]["host"].append((h1 - h0) * 1e3)
        if cuda:
            torch.cuda.synchronize()
        if i >= 2:
            for name, e0, e1 in marks:
                out[name]["event"].append(e0.elapsed_time(e1))
            out["applied"].append(counts[0])
            out["touched"].append(counts[1])
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        sums = {k: 0.0 for k in ENTRIES}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(sweeps):
                for _name, fn in run.calls():
                    fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for k in ENTRIES:
                if KERNEL_NAMES[k] in e.key:
                    sums[k] += getattr(e, "self_device_time_total",
                                       getattr(e, "self_cuda_time_total", 0))
        for k in ENTRIES:
            out[k]["device_ms"] = sums[k] / 1e3 / sweeps if sums[k] else None
    return out


def timed(t: Tree, case: str, prob, seed, M: int) -> None:
    lp, st, pos = position(t, prob, seed)
    got = entry_times(t.torch, t.sr, t.sharded, lp, st, pos, M, SWEEPS,
                      t.cuda)
    for name in ENTRIES:
        times = sorted(got[name]["event"]) or [float("nan")]
        host = got[name]["host"]
        out = {"tree": t.tree, "case": case, "entry": name,
               "S_loc": lp.S, "N": lp.N, "M": M,
               "event_ms_median": statistics.median(times),
               "event_ms_min": times[0], "event_ms_max": times[-1],
               "device_ms": got[name]["device_ms"],
               "host_ms_median": statistics.median(host),
               "host_ms_min": min(host),
               "applied_median": statistics.median(got["applied"]),
               "touched_median": statistics.median(got["touched"]),
               "sweeps": SWEEPS}
        print(json.dumps(out), flush=True)


def widest(t: Tree, prob, seed):
    """The widest M in [1, WIDEST_PROBE] the tree's bind takes (the binds
    are monotone in M: bisection), or None."""
    from fleetflow_tpu_torch.core.errors import KernelError
    ok, bad, refusal = 0, WIDEST_PROBE + 1, None
    while bad - ok > 1:
        mid = (ok + bad) // 2
        try:
            t.sr.rank_sweep(*position(t, prob, seed), mid)
        except KernelError as e:
            bad, refusal = mid, f"{e}"[:200]
        else:
            ok = mid
    print(json.dumps({"tree": t.tree, "case": "widest", "M": ok,
                      "refused_from": bad, "refusal": refusal}), flush=True)
    return ok or None


def phases(t: Tree, case: str, prob, seed, M: int) -> None:
    """The stamped kernels' phase split (see the module docstring)."""
    import ctypes
    torch, np = t.torch, t.np
    lib = t._ext.library("k7_sharded_sweep")
    names = getattr(t.sr, "PHASE_SLOTS", None)
    if not hasattr(lib, "ff_set_phases") or names is None:
        print(json.dumps({"tree": t.tree, "case": f"phases {case}",
                          "stamps": False}), flush=True)
        return
    buf = torch.zeros((ROWS, SLOTS), dtype=torch.int64, device=t.dev)
    if lib.ff_set_phases(ctypes.c_void_p(buf.data_ptr())) != 0:
        raise RuntimeError("cannot set the phase buffer")
    run = Sweeps(torch, t.sr, t.sharded, *position(t, prob, seed), M)
    rows = {k: [] for k in names}
    for i in range(SWEEPS + 2):
        for name, fn in run.calls():
            buf.zero_()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            if name in rows and i >= 2:
                rows[name].append(buf.cpu().numpy().astype(np.float64))
    lib.ff_set_phases(ctypes.c_void_p(0))
    for name, slots in names.items():
        r = np.stack(rows[name])                    # (sweeps, ROWS, SLOTS)
        live = r[..., 2] > 0
        k = float((r[..., 1] - r[..., 0])[live].sum()
                  / r[..., 2][live].sum()) / 1e3   # us a cycle
        start = np.where(live, r[..., 0], np.inf).min(1)
        end = np.where(live, r[..., 1], 0).max(1)
        out = {"tree": t.tree, "case": f"phases {case}", "entry": name,
               "M": M, "blocks": int(live.sum(1).max()),
               "sm_mhz": 1e-3 / k,
               "span_us": float(np.median(end - start) / 1e3),
               "block_us": float(np.median(r[..., 2].max(1) * k))}
        for slot, label in slots.items():
            if label.endswith("_count"):
                out[label] = float(np.median(r[..., slot].sum(1)))
            else:
                out[f"{label}_us"] = float(np.median(r[..., slot].max(1) * k))
        print(json.dumps(out), flush=True)


def child(tree: str, cases, stamped: bool, device: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from fleetflow_tpu_torch import _ext
    if stamped:
        # a build of its own (the flags are part of the build's hash)
        _ext.NVCC_FLAGS = (*_ext.NVCC_FLAGS, "-DK7R_PHASES")
    if device != "cpu":
        _ext.build()
    t = Tree(tree, device)
    t.torch.use_deterministic_algorithms(False)
    for case, prob, seed, M in stagings(t, cases):
        if case == "widest":
            M = widest(t, prob, seed)
            if M is None:
                continue
        if stamped:
            phases(t, case, prob, seed, M)
        else:
            timed(t, case, prob, seed, M)


def main(argv: list[str]) -> int:
    cases = CASES
    device = "cuda:0"
    while argv[:1] in (["--cases"], ["--device"]):
        if argv[0] == "--cases":
            cases = tuple(argv[1].split(","))
        else:
            device = argv[1]
        argv = argv[2:]
    if not set(cases) <= set(CASES):
        print(f"unknown case in {cases}; the cases: {CASES}",
              file=sys.stderr)
        return 2
    if argv[:1] in (["--child"], ["--phases"]):
        child(argv[1], cases, argv[0] == "--phases", device)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(card, flush=True)
    shapes = [x for x in cases if x != "phases"]
    runs = ["--child"] + (["--phases"] if "phases" in cases
                          and device != "cpu" else [])
    rc = 0
    for tree in argv:
        for mode in runs:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cases",
                 ",".join(shapes), "--device", device, mode, tree],
                capture_output=True, text=True, timeout=1200)
            print(run.stdout, end="", flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
