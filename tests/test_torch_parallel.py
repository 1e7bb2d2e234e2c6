"""fleetflow_tpu_torch.parallel and the paths across ranks, against the
reference on the CPU.

Single-process cases: the rendezvous parsing (the reference's FLEET_*
triple and torchrun's environment), init_multihost's no-op and its
refusals, mesh_info's keys, chain_mesh past the world size.

One 4-rank gloo run on the CPU (tests/torch_parallel_worker.py, four
processes spawned once for the module, a rendezvous timeout of 60 s and
180 s for the whole run). The parent computes the reference's side
with JAX on conftest's 8 virtual CPU devices and hands it to the workers
through a file in tmp_path; each check below reads the workers' results:

* the reference multihost test's cross-process sum (one row a rank);
* a 2x2 tempered ``anneal_sharded`` across the ranks given the
  reference's jax.random draws (recorded through the draw seam of the
  port's one-device 2x2 run, which the rank path replays, checking that
  its position's hot mask stays on the recorded path): its assignment,
  sweeps and swap counters equal the reference's, the violation parts
  too, the soft score within TestAnnealParity's rel 1e-5; from the one-
  device run's initial state, its assignment and every replica plane
  equal the one-device 2x2 mesh's bit for bit;
* ShardedResident's staging and three churn merges: each rank's rows and
  node planes equal the reference's ShardedResident on a 2x2 mesh, and
  per_device_bytes equals the reference's;
* solve_sharded cold and warm over the 2x2 ranks held to the contract of
  test_torch_sharded.TestSolveContract (0 violations, no host repair,
  nothing on a dead node, a warm moved fraction within 5 points of the
  reference's solve_sharded from the same cold assignment), every rank
  the same result;
* solve(mesh=) on chain meshes of 2 and 4 ranks equal bit for bit to the
  one-process solve with the same chains and seed, and feasible at the
  reference's TestMeshSharding size (80x8, 8 chains, 200 steps);
* GpuSolverScheduler(mesh=) on the 4 ranks: a cold place and a one-node-
  down reschedule equal to the one-process scheduler's (the sub-solve
  off: a solve on a mesh takes none).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import sharded as ref_sh
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu_torch import parallel
from fleetflow_tpu_torch.core.errors import DeviceUnavailable, SolverError
from fleetflow_tpu_torch.entry import dryrun_multichip
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.solver import sharded as sh
from fleetflow_tpu_torch.solver.buckets import pad_problem as port_pad
from fleetflow_tpu_torch.solver.repair import verify
from test_torch_problem import staged_pair, to_np
from test_torch_sharded import SOFT_RTOL, JaxDraws, _churn_values

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
RANKS = 4
RENDEZVOUS_S = 60
SESSION_S = 180
RANK_ENV = ("FLEET_COORD", "FLEET_NUM_PROCS", "FLEET_PROC_ID", "RANK",
            "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def no_rank_env(monkeypatch):
    for name in RANK_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


class TestSingleProcess:
    def test_no_environment_is_a_no_op(self, no_rank_env):
        assert parallel.rendezvous() is None
        assert parallel.init_multihost() is False
        assert not parallel.is_initialized()
        assert parallel.world() == parallel.World(0, 1, None, None)

    def test_env_triple_and_torchrun_env(self, no_rank_env):
        no_rank_env.setenv("FLEET_COORD", "10.0.0.1:4000")
        no_rank_env.setenv("FLEET_NUM_PROCS", "4")
        no_rank_env.setenv("FLEET_PROC_ID", "3")
        assert parallel.rendezvous() == {
            "coordinator": "10.0.0.1:4000", "num_processes": 4,
            "process_id": 3, "local_rank": 3}
        # arguments win over the environment
        assert parallel.rendezvous("h:1", 2, 1)["coordinator"] == "h:1"
        for name in ("FLEET_COORD", "FLEET_NUM_PROCS", "FLEET_PROC_ID"):
            no_rank_env.delenv(name)
        no_rank_env.setenv("MASTER_ADDR", "10.0.0.2")
        no_rank_env.setenv("MASTER_PORT", "29511")
        no_rank_env.setenv("WORLD_SIZE", "8")
        no_rank_env.setenv("RANK", "5")
        no_rank_env.setenv("LOCAL_RANK", "1")
        assert parallel.rendezvous() == {
            "coordinator": "10.0.0.2:29511", "num_processes": 8,
            "process_id": 5, "local_rank": 1}

    def test_refusals(self, no_rank_env):
        with pytest.raises(SolverError, match="FLEET_PROC_ID"):
            parallel.rendezvous("h:1", 2)
        with pytest.raises(SolverError):
            parallel.rendezvous("h:1", 2, 2)
        if not torch.cuda.is_available():
            # no card and no device="cpu": no rank runs on the host
            with pytest.raises(DeviceUnavailable):
                parallel.init_multihost("127.0.0.1:1", 1, 0)
        with pytest.raises(SolverError, match="gloo"):
            parallel.init_multihost("127.0.0.1:1", 1, 0, device="cpu",
                                    backend="nccl")
        with pytest.raises(SolverError):
            parallel.init_multihost("127.0.0.1:1", 1, 0, device="cpu",
                                    backend="mpi")
        assert not parallel.is_initialized()

    def test_mesh_info_has_the_reference_keys(self):
        from fleetflow_tpu import parallel as ref_parallel
        ref = ref_parallel.mesh_info()
        port = parallel.mesh_info()
        assert set(ref) <= set(port)
        assert port["process_index"] == 0 and port["process_count"] == 1
        assert port["distributed"] is False

    def test_chain_mesh_past_the_world_raises(self):
        with pytest.raises(ValueError, match="init_multihost"):
            parallel.chain_mesh(2)
        with pytest.raises(ValueError):
            parallel.chain_mesh(5)

    def test_a_missing_rank_raises(self, no_rank_env):
        """The rendezvous has a finite timeout: rank 0 of 2 whose peer
        never comes raises (torch.distributed's DistError, a
        RuntimeError) and leaves the process single."""
        with pytest.raises(RuntimeError):
            parallel.init_multihost(f"127.0.0.1:{_free_port()}", 2, 0,
                                    device="cpu", timeout=2.0)
        assert not parallel.is_initialized()

    def test_solve_on_a_mesh_checks_its_chains(self, monkeypatch):
        """solve(mesh=): chains a multiple of the mesh's size, a 1-D
        mesh; refused before any collective runs."""
        from fleetflow_tpu_torch.solver.api import solve
        monkeypatch.setattr(parallel, "world", lambda: parallel.World(
            0, 2, torch.device("cpu"), "gloo"))
        mesh = parallel.chain_mesh()
        assert mesh.size == 2 and mesh.position == (0,)
        pt = synthetic_problem(40, 6, seed=1)
        with pytest.raises(ValueError, match="multiple"):
            solve(pt, mesh=mesh, chains=3)
        with pytest.raises(ValueError, match="1-D"):
            solve(pt, mesh=sh.tempering_mesh(1, 2), chains=2)


# -- the 4-rank run --------------------------------------------------------

class RecordingDraws:
    """JaxDraws that records what it hands out (and the hot masks it was
    handed), for the workers to replay."""

    def __init__(self, key):
        self.inner = JaxDraws(key, True)
        self.proposals_rec, self.exchange_rec = [], []

    def proposals(self, sweep, hot, N, M):
        out = self.inner.proposals(sweep, hot, N, M)
        self.proposals_rec.append((hot.clone(), *out))
        return out

    def exchange(self, R, device):
        u = self.inner.exchange(R, device)
        self.exchange_rec.append(u)
        return u

    def record(self) -> dict:
        return {"proposals": self.proposals_rec,
                "exchange": self.exchange_rec}


ANNEAL = dict(S=80, N=12, seed=5, adaptive=True, block=4, exchange_every=1,
              steps=24, extras=dict(strategy="fill_lowest", preferred=True,
                                    coloc=True))
MERGE = dict(S=73, N=12, seed=9)
CONTRACT = dict(shape=(320, 40), seed=4)
# the reference's TestMeshSharding solve (adaptive, 200 steps) and a
# fixed budget of 24 sweeps (every chain sweeps to the end)
CHAIN = dict(shape=(80, 8), seed=10, chains=8, variants={
    "adaptive": dict(steps=200), "fixed": dict(steps=24, adaptive=False)})
SCHED = dict(shape=(300, 30), seed=6, chains=4, steps=64)


def _anneal_case() -> dict:
    c = ANNEAL
    dp, tp, _, _ = staged_pair(c["S"], c["N"], c["seed"], packed=False,
                               **c["extras"])
    dpp, orig = ref_sh.pad_problem(dp, 2)
    tpp, _ = port_pad(tp, 2)
    init = np.zeros(dpp.S, np.int32)
    key = jax.random.PRNGKey(c["seed"])
    kw = dict(steps=c["steps"], adaptive=c["adaptive"], block=c["block"],
              n_real=orig, exchange_every=c["exchange_every"],
              return_stats=True, trace_blocks=8)
    ref = ref_sh.anneal_sharded(dpp, jnp.asarray(init), key,
                                mesh=ref_sh.tempering_mesh(2, 2), **kw)
    one_mesh = sh.tempering_mesh(2, 2, devices=["cpu"] * 4)
    rec_ref = RecordingDraws(key)
    one = sh.anneal_sharded(tpp, torch.tensor(init), mesh=one_mesh,
                            draws=rec_ref, **kw)
    state = sh.chain_states_from_assignment(
        dataclasses.replace(tpp, n_real=orig),
        torch.tensor(init).reshape(1, -1).expand(2, -1).contiguous())
    init_state = sh.ChainState(*(t.clone() for t in state))
    rec_state = RecordingDraws(key)
    one_state = sh.anneal_sharded(tpp, None, mesh=one_mesh, draws=rec_state,
                                  init_state=state, **kw)
    return dict(prob=tpp, init=torch.tensor(init), n_real=orig,
                steps=c["steps"], adaptive=c["adaptive"], block=c["block"],
                exchange_every=c["exchange_every"], rec_ref=rec_ref.record(),
                rec_state=rec_state.record(), init_state=init_state,
                ref=ref, one=one, one_state=one_state, final_state=state)


def _merge_case() -> dict:
    c = MERGE
    rng = np.random.default_rng(c["seed"])
    ref_pt = ref_synthetic(c["S"], c["N"], seed=c["seed"], port_fraction=0.3)
    pt = synthetic_problem(c["S"], c["N"], seed=c["seed"], port_fraction=0.3)
    ref_rp = ref_sh.ShardedResident(ref_pt, mesh=ref_sh.tempering_mesh(2, 2))
    seed = np.arange(c["S"], dtype=np.int32) % c["N"]
    ref_rp.adopt_host(seed, ref_pt.node_valid, warm=False)
    churn, planes = [], []
    for _ in range(3):
        valid, cap, rows, dem = _churn_values(pt, rng)
        churn.append((valid, cap, rows, dem))
        ref_pt = dataclasses.replace(ref_pt, node_valid=valid, capacity=cap,
                                     demand=dem)
        pt = dataclasses.replace(pt, node_valid=valid, capacity=cap,
                                 demand=dem)
        ref_rp.apply_delta(ref_pt, RefDelta(node_valid=valid, capacity=cap,
                                            demand_rows=(rows, dem[rows])))
        step = {}
        for name in ("demand", "capacity", "conflict_ids", "coloc_ids",
                     "eligible", "node_valid", "node_topology"):
            r = np.asarray(getattr(ref_rp.prob, name))
            step[name] = r.view(np.int32) if r.dtype == np.uint32 else r
        step["assignment"] = np.asarray(ref_rp.assignment)
        step["n_real"] = int(ref_rp.prob.n_real)
        planes.append(step)
    return dict(pt=synthetic_problem(c["S"], c["N"], seed=c["seed"],
                                     port_fraction=0.3),
                seed=seed, churn=churn, planes=planes,
                bytes=ref_sh.per_device_bytes(ref_rp.prob, state=True))


def _chain_case() -> dict:
    from fleetflow_tpu_torch.solver.api import solve
    c = CHAIN
    pt = synthetic_problem(*c["shape"], seed=c["seed"])
    out = {}
    for variant, kw in c["variants"].items():
        res = solve(pt, device="cpu", chains=c["chains"], seed=c["seed"],
                    **kw)
        out[variant] = dict(assignment=res.assignment, stats=res.stats,
                            soft=res.soft, steps=res.steps,
                            accepted=res.accepted_moves,
                            telemetry=res.telemetry, chains=res.chains)
    return out


def _sched_case(monkeypatch) -> list:
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.solver.resident import ProblemDelta
    q = SCHED
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pt = synthetic_problem(*q["shape"], seed=q["seed"], n_tenants=3)
    sched = GpuSolverScheduler(device="cpu", chains=q["chains"],
                               steps=q["steps"])
    first = sched.place(pt, stage="s")
    valid = pt.node_valid.copy()
    valid[int(np.argmax(np.bincount(first.raw, minlength=pt.N)))] = False
    again = sched.reschedule(dataclasses.replace(pt, node_valid=valid),
                             delta=ProblemDelta(node_valid=valid), stage="s")
    monkeypatch.delenv("FLEET_SUBSOLVE")
    return [dict(raw=p.raw, feasible=p.feasible, soft=p.soft)
            for p in (first, again)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 reference devices")
    from fleetflow_tpu_torch import _ext
    _ext.host_library("ffplacer")      # built once, before the ranks start
    out = tmp_path_factory.mktemp("ranks")
    mp = pytest.MonkeyPatch()
    try:
        case = dict(anneal=_anneal_case(), merge=_merge_case(),
                    contract=CONTRACT, chain=CHAIN, sched=SCHED)
        expect = dict(chain=_chain_case(), sched=_sched_case(mp),
                      dryrun=dryrun_multichip(RANKS, device="cpu"))
    finally:
        mp.undo()
    torch.save({k: case[k] for k in ("anneal", "merge", "contract", "chain",
                                     "sched")}, out / "case.pt")
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["FLEET_COORD"] = f"127.0.0.1:{_free_port()}"
    env["FLEET_NUM_PROCS"] = str(RANKS)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(RANKS):
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(out)], cwd=str(REPO),
            env=dict(env, FLEET_PROC_ID=str(rank)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SESSION_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(i, p.returncode, log[-3000:])
              for i, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    results = [torch.load(out / f"result-{i}.pt", weights_only=False)
               for i in range(RANKS)]
    return case, expect, results


def test_cross_process_sum(ranks_run):
    _case, _expect, results = ranks_run
    expect = sum(range(1, RANKS + 1)) * 8.0
    for r in results:
        assert r["sum"] == expect and r["int_sum"] == expect
        assert r["min"] == 0
        info = r["info"]
        assert info["distributed"] and info["process_count"] == RANKS
        assert info["global_devices"] == RANKS and info["backend"] == "gloo"
    assert sorted(r["info"]["process_index"] for r in results) == \
        list(range(RANKS))
    assert max(r["seconds"] for r in results) < SESSION_S


def test_tempered_anneal_matches_the_reference(ranks_run):
    case, _expect, results = ranks_run
    ref = case["anneal"]["ref"]
    for r in results:
        port = r["anneal_ref"]
        assert np.array_equal(np.asarray(ref.assignment),
                              to_np(port["assignment"]))
        assert int(ref.sweeps) == port["sweeps"]
        assert int(ref.swap_attempts) == port["swap_attempts"]
        assert int(ref.swap_accepts) == int(port["swap_accepts"])
        for part in ("capacity", "conflicts", "eligibility", "skew"):
            assert float(getattr(ref, part)) == float(port[part]), part
        np.testing.assert_allclose(float(port["soft"]), float(ref.soft),
                                   rtol=SOFT_RTOL)
        rt, pt_ = np.asarray(ref.telemetry), to_np(port["telemetry"])
        for col in (0, 2, 4, 5):
            assert np.array_equal(rt[:, col], pt_[:, col]), col
    assert int(case["anneal"]["ref"].swap_attempts) > 0


def test_a_cross_rank_sweep_has_two_collectives(ranks_run):
    """One cross-rank sweep (rank_step) on each of the 4 gloo ranks
    issues one all_min (the election slots) and one all_gather (the
    records) over its replica's ranks, and no all_sum_int
    (collectives.STATS)."""
    _case, _expect, results = ranks_run
    for r in results:
        assert r["sweep_collectives"] == {"all_min": 1, "all_gather": 1}
    assert sum(r["sweep_applied"] for r in results) > 0


def test_tempered_anneal_equals_the_one_device_mesh(ranks_run):
    """From the one-device run's initial state: the assignment and every
    replica plane bit-equal to the one-device 2x2 mesh's."""
    case, _expect, results = ranks_run
    a = case["anneal"]
    one, final = a["one_state"], a["final_state"]
    S_loc = a["prob"].S // 2
    for r in results:
        port = r["anneal_state"]
        assert torch.equal(port["assignment"], one.assignment)
        assert port["sweeps"] == one.sweeps
        assert int(port["swap_accepts"]) == int(one.swap_accepts)
        assert float(port["soft"]) == pytest.approx(float(one.soft),
                                                    rel=SOFT_RTOL)
        rep, shard = divmod(r["rank"], 2)
        planes = r["anneal_planes"]
        assert torch.equal(planes[0][0], final.assignment[
            rep, shard * S_loc:(shard + 1) * S_loc])
        for got, want in zip(planes[1:], final[1:]):
            assert torch.equal(got[0], want[rep])
    # the one-device run from the K3-built state is the reference's too
    assert np.array_equal(np.asarray(a["ref"].assignment),
                          to_np(a["one"].assignment))


def test_resident_staging_and_merges(ranks_run):
    case, _expect, results = ranks_run
    m = case["merge"]
    for r in results:
        shard = r["rank"] % 2
        for step, (want, got) in enumerate(zip(m["planes"], r["merge"])):
            S = got["padded_S"]
            lo, hi = shard * S // 2, (shard + 1) * S // 2
            assert S == want["demand"].shape[0]
            for name in ("demand", "conflict_ids", "coloc_ids", "eligible"):
                assert np.array_equal(want[name][lo:hi], to_np(got[name])), \
                    (name, step)
            for name in ("capacity", "node_valid", "node_topology"):
                assert np.array_equal(want[name], to_np(got[name])), name
            assert np.array_equal(want["assignment"][lo:hi],
                                  to_np(got["assignment"]))
            assert got["real_rows"] == want["n_real"]
            assert got["n_real"] == min(max(want["n_real"] - lo, 0), hi - lo)
        assert r["bytes"] == m["bytes"]


def test_solve_sharded_holds_the_contract(ranks_run):
    _case, _expect, results = ranks_run
    c = CONTRACT
    pt = synthetic_problem(*c["shape"], seed=c["seed"], n_tenants=3)
    cold, warm = results[0]["contract"]
    valid = results[0]["contract_valid"]
    for r in results:
        for got, want in zip(r["contract"], (cold, warm)):
            assert np.array_equal(got["assignment"], want["assignment"])
    assert cold["feasible"] and cold["pre"] == 0
    assert verify(pt, cold["assignment"])["total"] == 0
    assert cold["tempering"]["replicas"] == 2
    assert warm["feasible"] and warm["pre"] == 0 and warm["moves"] == 0
    assert valid[warm["assignment"]].all() and warm["h2d"] == 0
    pt2 = dataclasses.replace(pt, node_valid=valid)
    assert verify(pt2, warm["assignment"])["total"] == 0
    forced = float((~valid[cold["assignment"]]).mean())
    moved = float((warm["assignment"] != cold["assignment"]).mean())
    ref_pt = ref_synthetic(*c["shape"], seed=c["seed"], n_tenants=3)
    ref_rp = ref_sh.ShardedResident(ref_pt, mesh=ref_sh.tempering_mesh(2, 2))
    ref_rp.adopt_host(cold["assignment"], ref_pt.node_valid, warm=False)
    ref_pt2 = dataclasses.replace(ref_pt, node_valid=valid.copy())
    ref_rp.apply_delta(ref_pt2, RefDelta(node_valid=valid.copy()))
    ref_warm = ref_sh.solve_sharded(ref_pt2, resident=ref_rp,
                                    resident_warm=True, steps=64,
                                    seed=c["seed"] + 1)
    ref_moved = float((ref_warm.assignment != cold["assignment"]).mean())
    assert ref_warm.feasible
    assert forced <= moved <= ref_moved + 0.05, (moved, ref_moved, forced)


@pytest.mark.parametrize("variant", ["adaptive", "fixed"])
@pytest.mark.parametrize("ranks", ["two", "four"])
def test_chain_mesh_solve_equals_one_process(ranks_run, ranks, variant):
    _case, expect, results = ranks_run
    want = expect["chain"][variant]
    holders = [r for r in results if (ranks, variant) in r["chain"]]
    assert len(holders) == {"two": 2, "four": 4}[ranks]
    pt = synthetic_problem(*CHAIN["shape"], seed=CHAIN["seed"])
    for r in holders:
        got = r["chain"][ranks, variant]
        assert np.array_equal(got["assignment"], want["assignment"])
        assert got["stats"] == want["stats"]
        assert got["soft"] == want["soft"]
        assert got["steps"] == want["steps"]
        assert got["accepted"] == want["accepted"]
        assert got["chains"] == want["chains"] == CHAIN["chains"]
        assert got["telemetry"] == want["telemetry"]
    # the reference's solve(mesh=) contract at this size
    assert want["stats"]["total"] == 0
    assert verify(pt, want["assignment"])["total"] == 0
    if variant == "fixed":
        assert want["steps"] == 24


def test_options_across_ranks(ranks_run):
    """overlap_host_work on a rank mesh and on a chain mesh: each rank
    calls its own callable once, the result is every rank's and, on the
    chain mesh, the one-process solve's; solve_sharded's proposal width
    reaches the ranks and is reported."""
    _case, expect, results = ranks_run
    first = results[0]["options"]
    want = expect["chain"]["adaptive"]
    for r in results:
        o = r["options"]
        assert o["calls"] == [r["rank"]] and o["overlap"]
        assert o["width"] == 16 and o["stats"]["total"] == 0
        assert np.array_equal(o["assignment"], first["assignment"])
        c = r["chain_overlap"]
        assert c["calls"] == [r["rank"]] and c["overlap"]
        assert np.array_equal(c["assignment"], want["assignment"])
        assert c["soft"] == want["soft"] and c["steps"] == want["steps"]


def test_scheduler_on_the_chain_mesh(ranks_run):
    _case, expect, results = ranks_run
    for r in results:
        assert r["sched_sub"] is None
        for got, want in zip(r["sched"], expect["sched"]):
            assert np.array_equal(got["raw"], want["raw"])
            assert got["feasible"] and want["feasible"]
            assert got["soft"] == want["soft"]
            assert got["source"] == "gpu-anneal"


def test_dryrun_chain_layout_over_the_ranks(ranks_run):
    """dryrun_multichip's chain layout over chain_mesh() (its chains
    spread over the 4 ranks) and its sharded layouts on each rank give the
    one-process dry run's result."""
    _case, expect, results = ranks_run
    for r in results:
        assert r["dryrun"] == expect["dryrun"]
    assert expect["dryrun"]["ragged_violations"] == 0
