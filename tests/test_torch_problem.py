"""fleetflow_tpu_torch staging parity: the port's synthetic generator and
problem staging against the JAX package, on the CPU.

Also home to the helpers the other test_torch_* files import: one seeded
instance, staged by both packages on the same data.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.core.model import PlacementStrategy as RefStrategy
from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import problem as ref_problem
from fleetflow_tpu_torch.convert import (padded_problem_from_reference,
                                         plan_from_reference,
                                         problem_from_reference,
                                         resident_from_reference,
                                         state_from_reference,
                                         tensors_from_reference)
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.core.model import PlacementStrategy
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.solver import problem as port_problem

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
PT_ARRAYS = ("demand", "capacity", "dep_adj", "dep_depth", "port_ids",
             "volume_ids", "anti_ids", "coloc_ids", "eligible", "node_valid",
             "node_topology")
STRATEGIES = ("spread_across_pool", "pack_into_dedicated", "fill_lowest")


def make_pair(S: int, N: int, seed: int, *, n_tenants: int = 3,
              strategy: str = "spread_across_pool", max_skew: int = 0,
              domains: int = 0, preferred: bool = False, coloc: bool = False):
    """The same seeded instance as (reference ProblemTensors, port
    ProblemTensors). Optional extras, drawn from one numpy seed and applied
    to both: a spread constraint over `domains` topology domains, a soft
    preference plane, colocation ids."""
    ref_pt = ref_synthetic(S, N, seed=seed, n_tenants=n_tenants,
                           port_fraction=0.2, volume_fraction=0.1,
                           strategy=RefStrategy(strategy))
    port_pt = synthetic_problem(S, N, seed=seed, n_tenants=n_tenants,
                                port_fraction=0.2, volume_fraction=0.1,
                                strategy=PlacementStrategy(strategy))
    rng = np.random.default_rng(1000 + seed)
    extra = {}
    if max_skew:
        extra["max_skew"] = max_skew
        extra["node_topology"] = (np.arange(N) % max(domains, 1)).astype(
            np.int32)
    if preferred:
        extra["preferred"] = (rng.random((S, N)) * 0.5).astype(np.float32)
    if coloc:
        extra["coloc_ids"] = rng.integers(-1, 4, size=(S, 2)).astype(np.int32)
    ref_pt = dataclasses.replace(ref_pt, **{k: (v.copy() if hasattr(v, "copy")
                                                else v)
                                            for k, v in extra.items()})
    port_pt = dataclasses.replace(port_pt, **{k: (v.copy() if hasattr(v, "copy")
                                                  else v)
                                              for k, v in extra.items()})
    return ref_pt, port_pt


def ref_arrays(dp) -> tuple[dict, dict]:
    """A DeviceProblem's fields as numpy arrays + its statics."""
    arrays = {k: np.asarray(getattr(dp, k))
              for k in ("demand", "capacity", "conflict_ids", "coloc_ids",
                        "eligible", "node_valid", "node_topology")}
    for k in ("preferred", "n_real", "sticky_prev", "sticky_w"):
        v = getattr(dp, k)
        if v is not None:
            arrays[k] = np.asarray(v)
    statics = {k: getattr(dp, k) for k in ("S", "N", "G", "Gc", "T",
                                           "strategy", "max_skew")}
    return arrays, statics


def staged_pair(S: int, N: int, seed: int, packed: bool = True, **kw):
    """(reference DeviceProblem, port TorchProblem, ref pt, port pt)."""
    ref_pt, port_pt = make_pair(S, N, seed, **kw)
    dp = ref_problem.prepare_problem(ref_pt, packed=packed)
    tp = port_problem.prepare_problem(port_pt, CPU, packed=packed)
    return dp, tp, ref_pt, port_pt


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TestSynthetic:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_arrays_bit_equal(self, seed):
        ref_pt = ref_synthetic(300, 40, seed=seed, n_tenants=3)
        port_pt = synthetic_problem(300, 40, seed=seed, n_tenants=3)
        for name in PT_ARRAYS:
            a, b = getattr(ref_pt, name), getattr(port_pt, name)
            assert a.dtype == b.dtype, name
            assert np.array_equal(a, b), name
        assert ref_pt.strategy.value == port_pt.strategy.value
        assert ref_pt.service_names == port_pt.service_names

    def test_validate_raises_on_bad_shape(self):
        pt = synthetic_problem(20, 4, seed=0)
        bad = dataclasses.replace(pt, node_valid=np.ones(5, dtype=bool))
        with pytest.raises(SolverError):
            bad.validate()


class TestStaging:
    @pytest.mark.parametrize("packed", [True, False])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_prepare_problem_bit_equal(self, packed, seed):
        dp, tp, _, _ = staged_pair(257, 45, seed, packed=packed,
                                   preferred=not packed, coloc=True)
        for name in ("demand", "capacity", "conflict_ids", "coloc_ids",
                     "node_valid", "node_topology"):
            a, b = np.asarray(getattr(dp, name)), to_np(getattr(tp, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        e_ref = np.asarray(dp.eligible)
        e_port = to_np(tp.eligible)
        if packed:
            assert e_ref.dtype == np.uint32 and e_port.dtype == np.int32
            assert np.array_equal(e_ref.view(np.int32), e_port)
        else:
            assert np.array_equal(e_ref, e_port)
        for k in ("S", "N", "G", "Gc", "T", "strategy", "max_skew"):
            assert getattr(dp, k) == getattr(tp, k), k
        assert (dp.preferred is None) == (tp.preferred is None)
        if tp.preferred is not None:
            assert np.array_equal(np.asarray(dp.preferred),
                                  to_np(tp.preferred))

    def test_lookups_match_reference(self):
        dp, tp, _, _ = staged_pair(120, 70, 3)
        rng = np.random.default_rng(0)
        s = rng.integers(0, 120, 500)
        n = rng.integers(0, 70, 500)
        ref = np.asarray(ref_problem.eligible_lookup(
            dp.eligible, jnp.asarray(s), jnp.asarray(n)))
        port = to_np(port_problem.eligible_lookup(
            tp.eligible, torch.tensor(s), torch.tensor(n)))
        assert np.array_equal(ref, port)
        svc = np.arange(0, 120, 7)
        ref_rows = np.asarray(ref_problem.eligible_rows(
            dp.eligible, jnp.asarray(svc), 70))
        port_rows = to_np(port_problem.eligible_rows(
            tp.eligible, torch.tensor(svc), 70))
        assert np.array_equal(ref_rows, port_rows)
        assert np.array_equal(
            np.asarray(ref_problem.eligible_row(dp.eligible, 5, 70)),
            to_np(port_problem.eligible_row(tp.eligible, 5, 70)))

    def test_staging_does_not_alias_host_arrays(self):
        pt = synthetic_problem(30, 6, seed=0)
        tp = port_problem.prepare_problem(pt, CPU)
        before = pt.demand.copy()
        tp.demand.add_(1.0)
        assert np.array_equal(pt.demand, before)


class TestConvert:
    @pytest.mark.parametrize("packed", [True, False])
    def test_problem_from_reference(self, packed):
        dp, tp, _, _ = staged_pair(90, 33, 4, packed=packed)
        conv = problem_from_reference(*ref_arrays(dp), device=CPU)
        for f in dataclasses.fields(tp):
            a, b = getattr(conv, f.name), getattr(tp, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
            else:
                assert a == b, f.name

    def test_state_and_tensors_from_reference(self):
        from fleetflow_tpu.solver.anneal import chain_states_from_assignment
        dp, tp, ref_pt, port_pt = staged_pair(60, 12, 5)
        a = np.random.default_rng(0).integers(0, 12, 60).astype(np.int32)
        st = chain_states_from_assignment(dp, jnp.asarray(a))
        conv = state_from_reference(*(np.asarray(x) for x in st), device=CPU)
        assert conv.assignment.shape == (1, 60)
        assert np.array_equal(to_np(conv.used[0]), np.asarray(st.used))
        fields = {f.name: getattr(ref_pt, f.name)
                  for f in dataclasses.fields(ref_pt)}
        pt2 = tensors_from_reference(fields)
        for name in PT_ARRAYS:
            assert np.array_equal(getattr(pt2, name), getattr(port_pt, name))
        assert pt2.strategy is port_pt.strategy


    @pytest.mark.parametrize("packed", [True, False])
    def test_padded_problem_from_reference(self, packed, monkeypatch):
        from fleetflow_tpu.solver.buckets import stage_problem_tiers as ref_st
        from fleetflow_tpu_torch.solver.buckets import stage_problem_tiers
        monkeypatch.setenv("FLEET_PACKED", "1" if packed else "0")
        ref_pt, port_pt = make_pair(101, 19, 6, coloc=True)
        dp, rinfo = ref_st(ref_pt, reuse_device_constants=False)
        conv, info = padded_problem_from_reference(*ref_arrays(dp), 101,
                                                   device=CPU)
        tp, pinfo = stage_problem_tiers(port_pt, device=CPU)
        assert conv.S > 101 and conv.n_real == 101
        for f in dataclasses.fields(tp):
            a, b = getattr(conv, f.name), getattr(tp, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
            else:
                assert a == b, f.name
        assert info == pinfo and info.padded_S == rinfo.padded_S

    def test_plan_from_reference(self, monkeypatch):
        """A reference plan as the port's lean plan and its staged buffer:
        the plan's ints carried, the id lists those of its closure rows,
        and K5's plain stage of it equal to the reference's base and
        remapped ids."""
        from fleetflow_tpu.solver.subsolve import ActiveIndex, plan_active
        from fleetflow_tpu_torch.solver.buckets import width_bucket
        from fleetflow_tpu_torch.solver.problem import prepare_problem
        from fleetflow_tpu_torch.solver.subsolve import (ActivePlan,
                                                         k5_stage_plain)
        monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
        monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "1.0")
        ref_pt, port_pt = make_pair(300, 30, 2, n_tenants=1)
        mirror = np.random.default_rng(2).integers(0, 30, 320).astype(
            np.int32)
        valid = ref_pt.node_valid.copy()
        valid[5] = False
        cur = dataclasses.replace(ref_pt, node_valid=valid)
        plan, outcome = plan_active(ActiveIndex(ref_pt), cur, mirror, 320,
                                    30, np.array([3]))
        assert plan is not None, outcome
        fields = {f.name: getattr(plan, f.name)
                  for f in dataclasses.fields(plan)}
        port_cur = dataclasses.replace(port_pt, node_valid=valid)
        conv, staged = plan_from_reference(fields, port_cur, device=CPU)
        assert isinstance(conv, ActivePlan)
        assert conv.rows.dtype == np.int32
        assert np.array_equal(conv.rows, fields["rows"])
        for name in ("n_sub", "tier", "G_sub", "Gc_sub", "affected"):
            assert getattr(conv, name) == fields[name], name
        assert conv.n_real == 300
        assert np.array_equal(to_np(staged), conv.packed())
        prob = prepare_problem(port_cur, CPU, extents=lambda S, K, C, G, Gc: (
            320, width_bucket(K), width_bucket(C), G, Gc))
        out = k5_stage_plain(prob, torch.tensor(mirror), staged, conv)
        for name in ("sub_conflict", "sub_coloc", "load0", "used0",
                     "coloc0", "topo0"):
            a, b = fields[name], to_np(getattr(out, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name

    def test_resident_from_reference(self):
        from fleetflow_tpu.solver import solve as ref_solve
        from fleetflow_tpu.solver.resident import ResidentProblem as RefRP
        ref_pt, port_pt = make_pair(90, 11, 3)
        ref_rp = RefRP(ref_pt)
        ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, steps=8,
                  bucket=True)
        pending = np.array([4, 9])
        rp = resident_from_reference(port_pt, ref_rp._mirror,
                                     ref_rp._mirror_feasible, pending,
                                     device=CPU)
        assert np.array_equal(to_np(rp.assignment), ref_rp._mirror)
        assert np.array_equal(rp._mirror, ref_rp._mirror)
        assert rp._mirror_feasible and rp._pending_churn
        assert np.array_equal(rp._pending_rows, pending)
        for name in ("demand", "conflict_ids", "coloc_ids", "eligible"):
            a = np.asarray(getattr(ref_rp.prob, name))
            a = a.view(np.int32) if a.dtype == np.uint32 else a
            assert np.array_equal(a, to_np(getattr(rp.prob, name))), name
        with pytest.raises(ValueError):
            resident_from_reference(port_pt, ref_rp._mirror[:90], True,
                                    device=CPU)


class TestBoundaries:
    def test_package_imports_no_jax(self):
        """Every module of the port (the obs package, the front end, the
        control plane and its wire, the runtime and its unit generators,
        lint, the cloud providers, the registry with its aggregation, the
        build subsystem, the node agent, the chaos world, the daemon, the
        CLI, the MCP server, the static-analysis package and the
        launch-contract registry, the ranks (``parallel``, the
        collectives and the sharded anneal across ranks) among them, their
        ``__main__`` modules included, which import without running) and
        chip_smoke.py
        import in a fresh interpreter without
        jax or fleetflow_tpu entering sys.modules."""
        code = (
            "import importlib, importlib.util, pkgutil, sys\n"
            "import fleetflow_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "'fleetflow_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke', "
            "'chip_smoke.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fleetflow_tpu'))\n"
            "obs = {'fleetflow_tpu_torch.obs.' + m for m in "
            "('metrics', 'trace', 'slo')} | {'fleetflow_tpu_torch.obs'}\n"
            "obs |= {'fleetflow_tpu_torch.' + m for m in ('core.kdl', "
            "'core.parser', 'core.loader', 'lower.fleetgen', 'native.kdl', "
            "'solver.explain', 'cp.models', 'cp.store', 'cp.placement', "
            "'cp.admission', 'cp.protocol', 'cp.shards', "
            "'cp.agent_registry', 'cp.failure_detector', 'cp.reconverge', "
            "'runtime', 'runtime.converter', 'runtime.backend', "
            "'runtime.waiter', 'runtime.engine', 'lint', 'lint.diagnostics', "
            "'lint.rules', 'lint.engine', 'lint.sarif', 'obs.tsdb', "
            "'obs.collector', 'cloud', 'cloud.action', 'cloud.state', "
            "'cloud.provider', 'cp.log_router', 'cp.auth', 'cp.autoscaler', "
            "'cp.replication', 'cp.server', 'cp.handlers', 'chaos', "
            "'chaos.faults', 'chaos.injector', 'chaos.worldgen', "
            "'chaos.invariants', 'chaos.runner', 'chaos.scenarios', "
            "'cp.crypto', 'cp.cert', 'cp.bench_agents', 'cloud.ssh', "
            "'cloud.startup_scripts', 'cloud.sakura', 'cloud.aws', "
            "'cloud.cloudflare', 'cloud.tailscale', 'registry', "
            "'registry.model', 'registry.deploy', 'chaos.trace', "
            "'chaos.simulate', 'registry.discovery', 'registry.parser', "
            "'registry.aggregate', 'runtime.quadlet', 'runtime.compose', "
            "'runtime.readiness', 'runtime.ports', 'runtime.static_site', "
            "'build', 'build.resolver', 'build.context', 'build.auth', "
            "'build.builder', 'agent', 'agent.guard', 'agent.monitor', "
            "'agent.agent', 'daemon', 'daemon.__main__', 'daemon.config', "
            "'daemon.daemon', 'daemon.health', 'daemon.pidfile', "
            "'daemon.web', 'cli', 'cli.__main__', 'cli.client', "
            "'cli.device_flow', 'cli.main', 'cli.self_update', "
            "'cli.utils', 'cli.wizard', 'mcp', 'mcp.server', 'analysis', "
            "'analysis.auditor', 'analysis.baseline', 'analysis.callgraph', "
            "'analysis.dataflow', 'analysis.hygiene', 'analysis.jitspec', "
            "'solver.contracts', 'parallel', 'solver.collectives', "
            "'solver.sharded_ranks')}\n"
            "print(len(mods), bad, sorted(obs - set(mods)))\n"
            "sys.exit(1 if bad or len(mods) < 15 or obs - set(mods) "
            "else 0)\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr

    def test_analysis_imports_no_torch(self):
        """`import fleetflow_tpu_torch.analysis` (the source passes) pulls
        neither torch nor numpy, as the reference's pulls no jax; the
        auditor's names load on first use."""
        code = ("import sys\n"
                "import fleetflow_tpu_torch.analysis as a\n"
                "a.hygiene_lint_source('x = 1\\n')\n"
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'numpy', 'jax', 'fleetflow_tpu')))\n"
                "print(callable(a.audit_kernels), 'torch' in sys.modules)\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines() == ["[]", "True False"]

    def test_solver_exports_every_counterpart(self):
        """The port's solver package exports every name the reference's
        package imports that has a counterpart here; the differences are
        named: JAX's mesh axis, compile-arena statistics and transfer
        guard have none, TorchProblem stands for DeviceProblem, and
        `anneal` is the submodule, whose `anneal` is the function."""
        import ast

        import fleetflow_tpu_torch.solver as port_solver
        from fleetflow_tpu_torch.solver import anneal as anneal_module
        src = (REPO / "fleetflow_tpu" / "solver" / "__init__.py").read_text()
        ref_names = {a.asname or a.name for node in ast.parse(src).body
                     if isinstance(node, ast.ImportFrom) for a in node.names}
        port_names = set(port_solver.__all__)
        assert all(hasattr(port_solver, n) for n in port_names)
        assert ref_names - port_names == {"CHAIN_AXIS", "DeviceProblem",
                                          "staging_arena_stats",
                                          "transfer_guard_ctx", "anneal"}
        assert port_names - ref_names == {"TorchProblem"}
        assert len(port_names) == 37
        assert callable(anneal_module.anneal)
        assert anneal_module.__name__ == "fleetflow_tpu_torch.solver.anneal"

    @pytest.mark.parametrize("package", ["registry", "runtime", "build",
                                         "agent"])
    def test_host_packages_export_every_counterpart(self, package):
        """The registry, runtime, build and agent packages export every
        name the reference's package exports, and nothing else."""
        import importlib
        ref = importlib.import_module(f"fleetflow_tpu.{package}")
        port = importlib.import_module(f"fleetflow_tpu_torch.{package}")
        assert set(port.__all__) == set(ref.__all__)
        assert all(hasattr(port, n) for n in port.__all__)
        for name in port.__all__:
            assert getattr(port, name).__module__.startswith(
                "fleetflow_tpu_torch."), name

    def test_scheduler_raises_without_cuda(self, monkeypatch):
        from fleetflow_tpu_torch.sched import GpuSolverScheduler
        from fleetflow_tpu_torch.solver import solve
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SolverError):
            GpuSolverScheduler()
        with pytest.raises(SolverError):
            solve(synthetic_problem(10, 3, seed=0))
        from fleetflow_tpu_torch.solver.multiplex import solve_multiplexed
        with pytest.raises(SolverError):
            solve_multiplexed([])
        with pytest.raises(SolverError):
            GpuSolverScheduler().place_many(
                [{"pt": synthetic_problem(10, 3, seed=0)}])
        assert GpuSolverScheduler(device="cpu").device == CPU

    def test_convert_raises_without_cuda(self, monkeypatch):
        """Carrying state across lands on the card by default, never on the
        host in its place."""
        dp, _, _, _ = staged_pair(30, 6, 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SolverError):
            problem_from_reference(*ref_arrays(dp))
        a = np.zeros((1, 30), np.int32)
        with pytest.raises(SolverError):
            state_from_reference(a, np.zeros((1, 6, 3), np.float32),
                                 np.zeros((1, 6, 1), np.int32),
                                 np.zeros((1, 6, 1), np.int32),
                                 np.zeros((1, 1), np.int32))

    def test_subsolve_carriers_raise_without_cuda(self, monkeypatch):
        """The padded-problem, plan and mirror carriers land on the card by
        default too."""
        dp, _, _, pt = staged_pair(30, 6, 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SolverError):
            padded_problem_from_reference(*ref_arrays(dp), 30)
        plan = {"rows": np.zeros(16, np.int32), "n_sub": 1, "tier": 16,
                "G_sub": 16, "Gc_sub": 0, "affected": 1}
        with pytest.raises(SolverError):
            plan_from_reference(plan, pt)
        with pytest.raises(SolverError):
            resident_from_reference(pt, np.zeros(64, np.int32), True)

    def test_stage_problem_tiers_raises_without_cuda(self, monkeypatch):
        """Padded staging lands on the card by default, never on the host
        in its place; the CPU only when asked for by name."""
        from fleetflow_tpu_torch.solver.buckets import stage_problem_tiers
        pt = synthetic_problem(30, 6, seed=1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SolverError):
            stage_problem_tiers(pt)
        prob, info = stage_problem_tiers(pt, device="cpu")
        assert prob.device == CPU and prob.S == info.padded_S > pt.S
        assert prob.n_real == pt.S

    def test_kernel_wrappers_take_plain_version_only_on_cpu(self):
        """A CPU tensor runs the plain version and launches nothing."""
        from fleetflow_tpu_torch import _ext
        from fleetflow_tpu_torch.solver.kernels import k3_rebuild
        _ext.reset_launches()
        _, tp, _, _ = staged_pair(40, 8, 0)
        k3_rebuild(tp, torch.zeros(40, dtype=torch.int32))
        assert sum(_ext.LAUNCHES.values()) == 0
