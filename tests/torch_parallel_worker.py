"""One rank of tests/test_torch_parallel.py's 4-rank gloo run on the CPU.

    FLEET_COORD=127.0.0.1:<port> FLEET_NUM_PROCS=4 FLEET_PROC_ID=<rank> \\
        python tests/torch_parallel_worker.py <session dir>

Joins the group (``parallel.init_multihost(device="cpu")``), reads what
the parent computed (``<dir>/case.pt``: the staged problems, the
reference's recorded draws and the churn), runs each check's port side on
its rank and writes ``<dir>/result-<rank>.pt``. Imports neither JAX nor
``fleetflow_tpu``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch


class ReplayDraws:
    """The draws a one-device run recorded, replayed in order; the hot mask
    of this rank's position must be the recorded one (the run walks the
    recorded path)."""

    def __init__(self, rec: dict, r: int, d: int):
        self.props = list(rec["proposals"])
        self.swaps = list(rec["exchange"])
        self.r, self.d = r, d

    def proposals(self, sweep, hot, N, M):
        want_hot, s, b, u = self.props.pop(0)
        if not torch.equal(hot[self.r, self.d], want_hot[self.r, self.d]):
            raise AssertionError(f"sweep {sweep}: the hot mask of position "
                                 f"({self.r}, {self.d}) left the recorded "
                                 f"path")
        return s, b, u

    def exchange(self, R, device):
        return self.swaps.pop(0)


def _stats(res) -> dict:
    return {k: (getattr(res, k) if isinstance(getattr(res, k), int)
                else getattr(res, k).clone())
            for k in res._fields}


def run(out_dir: str) -> dict:
    from fleetflow_tpu_torch import parallel
    from fleetflow_tpu_torch.lower.tensors import synthetic_problem
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.solver import collectives as coll
    from fleetflow_tpu_torch.solver import sharded as sh
    from fleetflow_tpu_torch.solver.anneal import ChainState
    from fleetflow_tpu_torch.solver.api import solve
    from fleetflow_tpu_torch.solver.resident import ProblemDelta

    t0 = time.perf_counter()
    assert parallel.init_multihost(device="cpu", timeout=60.0)
    assert parallel.init_multihost()            # a second call: no-op
    w = parallel.world()
    case = torch.load(os.path.join(out_dir, "case.pt"), weights_only=False)
    out: dict = {"rank": w.rank, "info": parallel.mesh_info()}

    # the reference multihost test's cross-process sum: one row a rank,
    # its value the rank's position + 1; the float sum in rank order and
    # the integer sum
    mesh4 = parallel.chain_mesh()
    g = mesh4.my_groups()["mesh"]
    rows = torch.full((1, 8), w.rank + 1.0)
    out["sum"] = float(coll.ordered_sum(rows, g).sum())
    out["int_sum"] = int(coll.all_sum_int_(
        torch.full((8,), w.rank + 1, dtype=torch.int32), g).sum())
    out["min"] = int(coll.all_min_(torch.tensor([w.rank], dtype=torch.int32),
                                   g)[0])

    # the 2x2 tempered anneal across the four ranks
    mesh = sh.tempering_mesh(2, 2)
    r, d = mesh.position
    a = case["anneal"]
    lp = sh.shard_problem(a["prob"], mesh)
    kw = dict(steps=a["steps"], mesh=mesh, adaptive=a["adaptive"],
              block=a["block"], n_real=a["n_real"],
              exchange_every=a["exchange_every"], return_stats=True,
              trace_blocks=8)
    res = sh.anneal_sharded(lp, a["init"], draws=ReplayDraws(
        a["rec_ref"], r, d), **kw)
    out["anneal_ref"] = _stats(res)
    S_loc = lp.S
    one = a["init_state"]
    st = ChainState(one.assignment[r:r + 1, d * S_loc:(d + 1) * S_loc]
                    .clone(), *(t[r:r + 1].clone() for t in one[1:]))
    res = sh.anneal_sharded(lp, None, draws=ReplayDraws(a["rec_state"], r, d),
                            init_state=st, **kw)
    out["anneal_state"] = _stats(res)
    out["anneal_planes"] = [t.clone() for t in st]

    # ShardedResident's staging and three merges on the 2x2 mesh
    m = case["merge"]
    pt = m["pt"]
    rp = sh.ShardedResident(pt, mesh=mesh)
    rp.adopt_host(m["seed"], pt.node_valid, warm=False)
    merged = []
    for valid, cap, rows_, dem in m["churn"]:
        pt = dataclasses.replace(pt, node_valid=valid, capacity=cap,
                                 demand=dem)
        rp.apply_delta(pt, ProblemDelta(node_valid=valid, capacity=cap,
                                        demand_rows=(rows_, dem[rows_])))
        merged.append({name: getattr(rp.prob, name).clone() for name in (
            "demand", "capacity", "conflict_ids", "coloc_ids", "eligible",
            "node_valid", "node_topology")}
            | {"assignment": rp.assignment.clone(),
               "n_real": rp.prob.n_real, "real_rows": rp.real_rows,
               "padded_S": rp.padded_S})
    out["merge"] = merged
    out["bytes"] = sh.per_device_bytes(rp.prob, rp.mesh, state=True)

    # solve_sharded cold and warm over the 2x2 ranks
    c = case["contract"]
    pt = synthetic_problem(*c["shape"], seed=c["seed"], n_tenants=3)
    rp = sh.ShardedResident(pt, mesh=mesh)
    cold = sh.solve_sharded(pt, resident=rp, steps=64, seed=c["seed"])
    valid = pt.node_valid.copy()
    busiest = np.argsort(-np.bincount(cold.assignment, minlength=pt.N))
    valid[busiest[:3]] = False
    pt2 = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(pt2, ProblemDelta(node_valid=valid))
    warm = sh.solve_sharded(pt2, resident=rp, resident_warm=True, steps=64,
                            seed=c["seed"] + 1)
    out["contract"] = [dict(assignment=x.assignment, feasible=x.feasible,
                            pre=x.pre_repair_violations,
                            moves=x.moves_repaired,
                            h2d=x.warm_h2d_copies, tempering=x.tempering,
                            stats=x.stats)
                       for x in (cold, warm)]
    out["contract_valid"] = valid
    # the options across the ranks: each rank's own callable, once, and a
    # proposal width of 16 a position
    calls = []
    pt_o = synthetic_problem(*c["shape"], seed=c["seed"], n_tenants=3)
    o = sh.solve_sharded(pt_o, resident=sh.ShardedResident(pt_o, mesh=mesh),
                         steps=64, seed=c["seed"], proposals_per_step=16,
                         overlap_host_work=lambda: calls.append(w.rank))
    out["options"] = dict(calls=calls, assignment=o.assignment,
                          width=o.proposals_per_step, stats=o.stats,
                          overlap="overlap_host_ms" in o.timings_ms)

    # the chain mesh: 2 ranks (ranks 2 and 3 hold no position, but make
    # the group with the others) and all 4
    s = case["chain"]
    pt = synthetic_problem(*s["shape"], seed=s["seed"])
    mesh2 = parallel.chain_mesh(2)
    assert (mesh2.groups() is None) == (w.rank >= 2)
    chains = {}
    for name, m_ in (("two", mesh2), ("four", mesh4)):
        if m_.position is None:
            continue
        for variant, kw in s["variants"].items():
            res = solve(pt, mesh=m_, chains=s["chains"], seed=s["seed"],
                        **kw)
            chains[name, variant] = dict(
                assignment=res.assignment, stats=res.stats, soft=res.soft,
                steps=res.steps, accepted=res.accepted_moves,
                telemetry=res.telemetry, chains=res.chains)
    out["chain"] = chains
    ccalls = []
    res = solve(pt, mesh=mesh4, chains=s["chains"], seed=s["seed"],
                overlap_host_work=lambda: ccalls.append(w.rank),
                **s["variants"]["adaptive"])
    out["chain_overlap"] = dict(calls=ccalls, assignment=res.assignment,
                                soft=res.soft, steps=res.steps,
                                overlap="overlap_host_ms" in res.timings_ms)

    # GpuSolverScheduler on the 4-rank chain mesh: a cold place and a
    # one-node-down reschedule
    q = case["sched"]
    pt = synthetic_problem(*q["shape"], seed=q["seed"], n_tenants=3)
    sched = GpuSolverScheduler(mesh=mesh4, chains=q["chains"],
                               steps=q["steps"])
    first = sched.place(pt, stage="s")
    valid = pt.node_valid.copy()
    valid[int(np.argmax(np.bincount(first.raw, minlength=pt.N)))] = False
    pt2 = dataclasses.replace(pt, node_valid=valid)
    again = sched.reschedule(pt2, delta=ProblemDelta(node_valid=valid),
                             stage="s")
    out["sched"] = [dict(raw=p.raw, feasible=p.feasible, soft=p.soft,
                         source=p.source) for p in (first, again)]
    out["sched_sub"] = sched.last_result.subsolve

    # the dry run's chain layout over the ranks
    from fleetflow_tpu_torch.entry import dryrun_multichip
    out["dryrun"] = dryrun_multichip(w.size)
    out["collectives"] = {k: v[0] for k, v in coll.STATS.items()}

    # one cross-rank sweep on its own, from the anneal's final state: the
    # collectives it issues, by operation
    from fleetflow_tpu_torch.solver import sharded_ranks as sr
    pos = sr.rank_position(mesh, lp.S)
    sweep = sr.rank_sweep(lp, ChainState(*(t.clone() for t in st)), pos, 16)
    gen = torch.Generator().manual_seed(3 + w.rank)
    s_loc = torch.randint(0, lp.S, (16,), generator=gen, dtype=torch.int32)
    b_idx = torch.randint(0, lp.N, (16,), generator=gen, dtype=torch.int32)
    coll.reset_stats()
    applied = sr.rank_step(sweep, mesh.my_groups()["svc"], s_loc, b_idx,
                           torch.rand(16, generator=gen), 50.0)
    out["sweep_collectives"] = {k: v[0] for k, v in coll.STATS.items()}
    out["sweep_applied"] = int(applied[0])
    out["seconds"] = time.perf_counter() - t0
    parallel.shutdown()
    return out


if __name__ == "__main__":
    directory = sys.argv[1]
    result = run(directory)
    path = os.path.join(directory, f"result-{result['rank']}.pt")
    torch.save(result, path + ".tmp")
    os.replace(path + ".tmp", path)
