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
           -DK7R_PHASES: the entry points' own cycle stamps, per phase

A case binds one RankSweepLauncher (``sharded_ranks.rank_sweep``) for
each position of the replica of position (0, 0), each on its shard and
its own copy of the replica's state, as ``anneal_ranks`` does on each rank
once a call, and runs SWEEPS sweeps of the whole replica through them:
each sweep draws every position's proposals (``sharded.TorchDraws``, its
hot mask from the current states), then every elect, the slots' MIN over
the positions, every apply, the records of every position stacked in
shard order (the gather), every reduce on that one tensor; a tree whose
apply writes a dense partial and integer deltas (the parent of the
records) gathers the partials and sums the deltas instead, the
collectives of the same replica. Position (0, 0)'s entry points are
timed, each on an idle card (a synchronize before it, as after a gloo
collective): the CUDA-event ms of the wrapper call and the wrapper's host
ms; a second run of the same sweeps under torch.profiler gives each
kernel's device ms. One JSON line a case and entry point: the medians and
ranges, the device ms (a launch, over every position's launches), and the
medians of what a sweep moved (``Sweeps.counts``). The phases case
prints, per entry point, each phase's median over the sweeps in
microseconds (the longest block's cycles at the SM clock the stamps
imply) and the launch's device span from the first block's start to the
last block's end, for each entry point the tree's PHASE_SLOTS names; a
tree without the stamps says so. The card's name and power limit come
first. The sharded fleet is made and pickled by each tree's tools/k67_profile.py (its
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
    """Position (0, 0) of a 2x2 mesh over `prob`: (`prob`, its replica's
    one-replica state of all rows from the (S,) assignment `seed`, the
    position)."""
    pos = t.sr.RankPosition(0, 0, 2, 2, prob.S, 0)
    whole = t.anneal.chain_states_from_assignment(
        prob, seed.to(t.torch.int32).reshape(1, -1).contiguous())
    return prob, whole, pos


def shard(t: Tree, prob, seed):
    """(its shard, its state, the position) of :func:`position`."""
    prob, whole, pos = position(t, prob, seed)
    st = t.anneal.ChainState(whole.assignment[:, :pos.S_loc].contiguous(),
                             *(x.contiguous() for x in whole[1:]))
    return t.sr.shard_rows(prob, pos), st, pos


class Sweeps:
    """Every position of the replica of `pos` on one card, each with one
    launcher bound once (``sharded_ranks.rank_sweep``) on its shard of
    the whole padded problem `prob` and its own copy of the replica's
    state (`whole`, a one-replica ChainState of all S rows), and each
    sweep's calls as the D ranks of the replica make them: every
    position's proposals drawn from the current states' hot mask
    (``sharded.TorchDraws``, seed 31), each position's elect, the slots'
    MIN over the positions, each apply, the records of every position
    stacked in shard order (the gather), each reduce on that one tensor.
    A tree without records (the parent of the records) gathers every
    position's partial and sums their integer deltas instead. Only the
    calls of position `pos` are named: the others are the rest of the
    replica's work, not timed."""

    def __init__(self, torch, sr, sharded, prob, whole, pos, M: int):
        self.torch, self.sr, self.pos, self.M = torch, sr, pos, M
        dev = whole.assignment.device
        S_loc = pos.S_loc
        self.shards = []
        for d in range(pos.D):
            at = sr.RankPosition(pos.r, d, pos.R, pos.D, pos.S, d * S_loc)
            lp = sr.shard_rows(prob, at)
            st = type(whole)(
                whole.assignment[:, d * S_loc:(d + 1) * S_loc].clone(),
                *(x.clone() for x in whole[1:]))
            self.shards.append((at, lp, st, sr.rank_scratch(lp, st, M)))
        self.lp, self.st = self.shards[pos.d][1], self.shards[pos.d][2]
        self.sweeps = [sr.rank_sweep(lp, st, at, M, sc)
                       for at, lp, st, sc in self.shards]
        self.sweep = self.sweeps[pos.d]
        gen = torch.Generator(device=dev)
        gen.manual_seed(31)
        self.draws = sharded.TorchDraws(gen)
        self.records = hasattr(self.sweep.scratch, "records")
        if self.records:
            self.layout = sr.record_layout(M, self.lp.N,
                                           self.lp.conflict_ids.shape[-1],
                                           self.lp.coloc_ids.shape[-1])
        self.hot = torch.zeros((pos.R, pos.D, S_loc), dtype=torch.bool,
                               device=dev)
        self.gathered = None
        self.i = 0

    def calls(self):
        """[(entry point or None, thunk)] of the next sweep."""
        torch, pos, sr = self.torch, self.pos, self.sr
        for (at, lp, st, _sc) in self.shards:
            self.hot[pos.r, at.d] = sr._hot(lp, st)[0]
        s_all, b_all, u_all = self.draws.proposals(self.i, self.hot,
                                                   self.lp.N, self.M)
        temp = 0.1 * 0.9 ** (self.i % 32)
        self.i += 1
        scs = [sw.scratch for sw in self.sweeps]

        def name(entry, d):
            return entry if d == pos.d else None

        def elect(d):
            args = tuple(x[pos.r, d].contiguous()
                         for x in (s_all, b_all, u_all))
            return lambda: self.sweeps[d].elect(*args, temp)

        def all_min():
            slots = torch.stack([sc.slots for sc in scs]).min(0).values
            for sc in scs:
                sc.slots.copy_(slots)

        def gather():
            if self.records:
                self.gathered = torch.stack([sc.records for sc in scs])
                return
            self.gathered = torch.stack([sc.partial for sc in scs])
            total = torch.stack([sc.deltas for sc in scs]).sum(0)
            for sc in scs:
                sc.deltas.copy_(total)

        def reduce(d):
            return lambda: self.sweeps[d].reduce(self.gathered)

        D = pos.D
        return ([(name("k7_rank_elect", d), elect(d)) for d in range(D)]
                + [(None, all_min)]
                + [(name("k7_rank_apply", d), self.sweeps[d].apply)
                   for d in range(D)]
                + [(None, gather)]
                + [(name("k7_rank_reduce", d), reduce(d))
                   for d in range(D)])

    def counts(self) -> dict:
        """What the sweep in flight moved, read between the gather and the
        reduces: the position's applied moves and node entries, and the
        replica's moves, id and topology cells (a move's ids and its
        topology once each), node entries and distinct touched nodes
        ("replica_applied", "replica_ids", "replica_entries",
        "replica_nodes"). A tree without records reports the moves and
        the touched nodes."""
        scs = [sw.scratch for sw in self.sweeps]
        own = scs[self.pos.d]
        if not self.records:
            N = self.lp.N
            return dict(applied=int(own.applied[0]),
                        replica_applied=sum(int(sc.applied[0]) for sc in scs),
                        replica_nodes=int((own.deltas[-N:] > 0).sum()))
        cap, wm, _words = self.layout
        out = dict(applied=0, entries=0, replica_applied=0, replica_ids=0,
                   replica_entries=0)
        nodes = []
        for d, rec in enumerate(self.gathered):
            count, ent, mv = self.sr.record_views(rec, cap, wm)
            n = int(count[0])
            live = ent[:2 * n, 0]
            live = live[live >= 0]
            nodes.append(live)
            if d == self.pos.d:
                out["applied"], out["entries"] = n, int(live.numel())
            out["replica_applied"] += n
            out["replica_entries"] += int(live.numel())
            out["replica_ids"] += int((mv[:n, 3:] >= 0).sum()) + int(
                (mv[:n, 2] > 0).sum())
        out["replica_nodes"] = int(self.torch.cat(nodes).unique().numel())
        return out

    def before_reduce(self):
        """Copies of the position's state and of the gathered records
        between the gather and the reduces (a plain reduce's inputs)."""
        return (type(self.st)(*(x.clone() for x in self.st)),
                self.gathered.clone())


def entry_times(torch, sr, sharded, prob, whole, pos, M: int, sweeps: int,
                cuda: bool = True) -> dict:
    """Each cross-rank entry point of position `pos` as ``anneal_ranks``
    launches it, its replica's other positions sweeping beside it
    (:class:`Sweeps` over the whole padded `prob` and the one-replica
    state `whole`), `sweeps` sweeps after two, each entry point on an idle
    card (a synchronize before it, as after a gloo collective): {entry:
    {"event": [ms], "host": [ms], "device_ms": ms a launch from
    torch.profiler over `sweeps` more (every position's launches), or
    None}, "moved": [Sweeps.counts() a timed sweep], "before_reduce": the
    last timed sweep's Sweeps.before_reduce()}. With `cuda` False (the
    plain versions on the CPU) no events and no device time."""
    run = Sweeps(torch, sr, sharded, prob, whole, pos, M)
    out = {k: {"event": [], "host": [], "device_ms": None} for k in ENTRIES}
    out["moved"] = []
    for i in range(sweeps + 2):
        marks = []
        for name, fn in run.calls():
            if name == "k7_rank_reduce" and i >= 2:
                out["moved"].append(run.counts())
                out["before_reduce"] = run.before_reduce()
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
            out[k]["device_ms"] = (sums[k] / 1e3 / (sweeps * pos.D)
                                   if sums[k] else None)
    return out


def timed(t: Tree, case: str, prob, seed, M: int) -> None:
    prob, whole, pos = position(t, prob, seed)
    got = entry_times(t.torch, t.sr, t.sharded, prob, whole, pos, M, SWEEPS,
                      t.cuda)
    moved = {k: statistics.median(m[k] for m in got["moved"])
             for k in got["moved"][0]}
    for name in ENTRIES:
        times = sorted(got[name]["event"]) or [float("nan")]
        host = got[name]["host"]
        out = {"tree": t.tree, "case": case, "entry": name,
               "S_loc": pos.S_loc, "N": prob.N, "M": M,
               "event_ms_median": statistics.median(times),
               "event_ms_min": times[0], "event_ms_max": times[-1],
               "device_ms": got[name]["device_ms"],
               "host_ms_median": statistics.median(host),
               "host_ms_min": min(host),
               **{f"{k}_median": v for k, v in moved.items()},
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
            t.sr.rank_sweep(*shard(t, prob, seed), mid)
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
