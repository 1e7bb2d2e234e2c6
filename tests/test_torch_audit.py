"""The port's static-analysis layer (fleetflow_tpu_torch/analysis and
solver/contracts.py) against the reference's (fleetflow_tpu/analysis), on
the CPU.

Mirrors tests/test_audit.py's classes with the same two obligations:

  1. the UNMODIFIED tree passes: the launch audit of every registered hot
     dispatch (run on the plain versions, ``device="cpu"``) has no
     intrinsic violation and equals the pinned contract
     (fleetflow_tpu_torch/analysis/launch_contract.json); the hygiene and
     dataflow passes find nothing in the port beyond its reviewed baseline
     (fleetflow_tpu_torch/analysis/audit_baseline.json), which holds no
     stale entry;
  2. every contract class has a failing world: an out-of-place merge, a
     sub-solve that writes its seed, a dense plane, a build at a later
     tier, a new knob or field, an unregistered dispatch — and every
     hygiene and dataflow rule a fixture in torch idiom that produces
     exactly its finding.

Parity with the reference, on the same inputs and exactly: the staged
problem's plane dtypes against tests/goldens/compile_contract.json (the
mapping: the packed eligibility words are int32 here with the reference's
uint32 bits, and the real-row count is a host int, a TorchProblem field,
not a plane); the reference's FJ005/FJ006 sources give the same codes,
lines and columns; the reference's call-graph fixtures give the same
edges; the baseline ledger's cases behave the same in both packages.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from fleetflow_tpu.analysis import baseline as ref_baseline
from fleetflow_tpu.analysis.callgraph import build_graph as ref_build_graph
from fleetflow_tpu.analysis.hygiene import \
    hygiene_lint_source as ref_hygiene_source
from fleetflow_tpu_torch import _ext
from fleetflow_tpu_torch.analysis import baseline as port_baseline
from fleetflow_tpu_torch.analysis.auditor import (audit_case, audit_kernels,
                                                  contract_diff,
                                                  default_contract_path,
                                                  render_contract)
from fleetflow_tpu_torch.analysis.baseline import (apply_baseline,
                                                   default_baseline_path,
                                                   load_baseline,
                                                   write_baseline)
from fleetflow_tpu_torch.analysis.callgraph import build_graph
from fleetflow_tpu_torch.analysis.dataflow import (dataflow_lint_paths,
                                                   dataflow_lint_source)
from fleetflow_tpu_torch.analysis.hygiene import (hygiene_lint_paths,
                                                  hygiene_lint_source)
from fleetflow_tpu_torch.analysis.jitspec import extract_jit_decl
from fleetflow_tpu_torch.cli.main import main as fleet_main
from fleetflow_tpu_torch.lint import Severity
from fleetflow_tpu_torch.solver import contracts, resident, subsolve
from fleetflow_tpu_torch.solver.contracts import (KernelCase, KernelContract,
                                                  audit_scale,
                                                  hot_path_kernels)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fleetflow_tpu_torch"
CPU = torch.device("cpu")
MERGES = ("resident.merge", "sharded.merge")
WARM = ("refine.warm", "mux.anneal", "subsolve.localized", "sharded.anneal")
SINGLE = ("resident.merge", "refine.warm", "mux.anneal",
          "subsolve.localized")


def _contract(name: str) -> KernelContract:
    return next(c for c in hot_path_kernels() if c.name == name)


def _pinned() -> dict:
    with open(default_contract_path(), encoding="utf-8") as f:
        return json.load(f)


# --------------------------------------------------------------------------
# the healthy tree: full audit == pinned contract
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report():
    return audit_kernels(device="cpu")


class TestContractHolds:
    def test_no_intrinsic_violations(self, report):
        assert report.violations == []
        assert report.skipped == []

    def test_matches_pinned_contract(self, report):
        assert contract_diff(report, _pinned()) == []

    def test_render_roundtrip(self, report):
        doc = json.loads(render_contract(report))
        assert contract_diff(report, doc) == []
        assert render_contract(report) == Path(
            default_contract_path()).read_text()

    def test_every_registered_dispatch_audited(self, report):
        """All six contracts at both audit tiers; none skipped (a mesh of
        this port names one card, so no contract needs more devices)."""
        names = [c.name for c in hot_path_kernels()]
        assert names == list(MERGES[:1]) + list(WARM[:3]) + [
            "sharded.merge", "sharded.anneal"]
        assert set(report["kernels"]) == set(names)
        for entry in report["kernels"].values():
            assert len(entry["tiers"]) == len(contracts.AUDIT_TIERS)

    def test_merges_write_their_planes_in_place(self, report):
        """The perf story itself: the node planes, the changed rows and
        the assignment's phantom tail are written where they lie, and
        nothing else the merge is handed is touched."""
        want = ["assignment", "prob.capacity", "prob.demand",
                "prob.eligible", "prob.node_valid"]
        for name in MERGES:
            for tier, rec in report["kernels"][name]["tiers"].items():
                assert rec["in_place"] == want, (name, tier)

    def test_warm_dispatches_keep_their_seeds(self, report):
        for name in WARM:
            keep = list(_contract(name).must_keep)
            for tier, rec in report["kernels"][name]["tiers"].items():
                assert rec["kept"] == keep and rec["in_place"] == [], \
                    (name, tier)
                assert set(rec["output_devices"].values()) == {"dispatch"}

    def test_no_build_on_the_cpu(self, report):
        """The plain versions build nothing (exactly 0 at every tier)."""
        for entry in report["kernels"].values():
            for rec in entry["tiers"].values():
                assert rec["builds"] == 0

    def test_problem_dtypes_match_the_reference_golden(self, report):
        """Parity: the staged planes of the four single-device contracts
        have the reference's dtypes under the stated mapping."""
        ref = json.loads((REPO / "tests" / "goldens"
                          / "compile_contract.json").read_text())
        for name in SINGLE:
            ref_tiers = list(ref["kernels"][name]["tiers"].values())
            port_tiers = list(report["kernels"][name]["tiers"].values())
            assert len(ref_tiers) == len(port_tiers) == 2
            for r, p in zip(ref_tiers, port_tiers):
                want = dict(r["problem_dtypes"])
                assert want.pop("prob.n_real") == "int32"
                assert want["prob.eligible"] == "uint32"
                want["prob.eligible"] = "int32"
                assert p["problem_dtypes"] == want, name

    def test_tier_labels_follow_the_reference(self, report):
        """The padded tiers of the reference's AUDIT_TIERS (64x12, 80x12)
        and its K = 2 lanes."""
        ref = json.loads((REPO / "tests" / "goldens"
                          / "compile_contract.json").read_text())
        for name in ("resident.merge", "refine.warm", "mux.anneal",
                     "sharded.merge", "sharded.anneal"):
            assert list(report["kernels"][name]["tiers"]) == \
                list(ref["kernels"][name]["tiers"]), name


# --------------------------------------------------------------------------
# canaries: one broken world per contract class
# --------------------------------------------------------------------------

def _first_case(name: str) -> KernelCase:
    return _contract(name).cases(CPU, audit_scale())[0]


class TestCanaries:
    def test_out_of_place_merge_fails(self, monkeypatch):
        """A merge that rebinds the demand plane to a new tensor
        (index_copy instead of index_copy_): the plane is no longer
        written where it lies and came back on a new storage."""
        good = resident.merge_delta

        def out_of_place(prob, assignment, node_valid, capacity,
                         demand_rows=None, eligible_rows=None, n_real=None,
                         *, first_valid):
            good(prob, assignment, node_valid, capacity, None,
                 eligible_rows, n_real, first_valid=first_valid)
            prob.demand = prob.demand.index_copy(0, *demand_rows)

        monkeypatch.setattr(resident, "merge_delta", out_of_place)
        contract = _contract("resident.merge")
        rec, violations = audit_case(contract, _first_case(contract.name))
        assert "prob.demand" not in rec["in_place"]
        assert any("not written in place: prob.demand" in v
                   for v in violations)
        assert any("new storage: prob.demand" in v for v in violations)

    def test_subsolve_writing_its_seed_fails(self, monkeypatch):
        """A sub-solve that writes the resident assignment it is handed:
        a rejected attempt could no longer re-seed from it."""
        good = subsolve.subsolve

        def writes_seed(prob, assignment, *a, **kw):
            out = good(prob, assignment, *a, **kw)
            assignment[:1] = (assignment[:1] + 1) % prob.N
            return out

        monkeypatch.setattr(subsolve, "subsolve", writes_seed)
        contract = _contract("subsolve.localized")
        rec, violations = audit_case(contract, _first_case(contract.name))
        assert rec["kept"] == []
        assert any("must-keep input assignment was written" in v
                   for v in violations)

    def test_refine_writing_its_seed_fails(self, monkeypatch):
        from fleetflow_tpu_torch.solver import api
        good = api._refine_lanes

        def writes_seeds(prob, seeds, *a, **kw):
            seeds.add_(0)
            return good(prob, seeds, *a, **kw)

        monkeypatch.setattr(api, "_refine_lanes", writes_seeds)
        contract = _contract("refine.warm")
        rec, violations = audit_case(contract, _first_case(contract.name))
        assert rec["kept"] == []
        assert any("seed_assignment was written" in v for v in violations)

    def test_dense_plane_fails_packed_contract(self, monkeypatch):
        """FLEET_PACKED=0 stages a dense bool eligibility plane and a
        materialized zero preference plane: both trip the packed-plane
        checks."""
        monkeypatch.setenv("FLEET_PACKED", "0")
        contract = _contract("resident.merge")
        rec, violations = audit_case(contract, _first_case(contract.name))
        assert rec["problem_dtypes"]["prob.eligible"] == "bool"
        assert any("bit-packed int32" in v for v in violations)
        assert rec["problem_dtypes"]["prob.preferred"] == "float32"
        assert any("preference plane" in v for v in violations)

    def test_build_at_a_later_tier_fails(self):
        """A dispatch that builds a kernel library at its second tier: a
        new tier must build nothing."""
        def building_merge(*args, **kw):
            _ext.M_COMPILE_EVENTS.inc()
            return resident.merge_delta(*args, **kw)

        def cases(device, scale):
            out = contracts._resident_merge_cases(device, scale)
            for c in out:
                c.fn = building_merge
            return out

        contract = dataclasses.replace(_contract("resident.merge"),
                                       cases=cases)
        rep = audit_kernels(device="cpu", kernels=[contract])
        assert any("1 kernel build(s) at a later tier" in v
                   for v in rep.violations)
        assert any("not the anchored merge_delta" in v
                   for v in rep.violations)

    def test_extra_static_arg_is_contract_drift(self, report):
        pinned = _pinned()
        entry = pinned["kernels"]["refine.warm"]
        entry["static_args"] = [a for a in entry["static_args"]
                                if a != "steps"]
        drift = contract_diff(report, pinned)
        assert any("refine.warm" in d and "static args" in d
                   for d in drift)

    def test_new_problem_field_is_contract_drift(self, report):
        pinned = _pinned()
        pinned["problem_static_fields"].append("new_axis")
        drift = contract_diff(report, pinned)
        assert any("problem_static_fields" in d for d in drift)

    def test_unregistered_dispatch_is_contract_drift(self, report):
        pinned = _pinned()
        pinned["kernels"]["ghost.kernel"] = {"static_args": [], "tiers": {}}
        drift = contract_diff(report, pinned)
        assert any("ghost.kernel" in d for d in drift)

    def test_lost_in_place_write_is_contract_drift(self, report):
        pinned = _pinned()
        for rec in pinned["kernels"]["sharded.merge"]["tiers"].values():
            rec["in_place"].remove("prob.eligible")
        drift = contract_diff(report, pinned)
        assert any("sharded.merge" in d and "in_place" in d for d in drift)

    def test_host_traffic_not_measured_on_the_cpu(self, report):
        """On the CPU host_traffic is null, never 0: nothing was
        measured, and the rendered golden carries no measured key."""
        assert report["_host_traffic"] == "not measured on the cpu"
        for entry in report["kernels"].values():
            for rec in entry["tiers"].values():
                assert rec["host_traffic"] is None
        doc = json.loads(render_contract(report))
        for entry in doc["kernels"].values():
            for rec in entry["tiers"].values():
                assert not {"host_traffic", "builds", "ms"} & set(rec)


# --------------------------------------------------------------------------
# jitspec: AST extraction is ground truth
# --------------------------------------------------------------------------

class TestJitSpec:
    def test_extracts_knobs(self):
        src = ("def f(x, t0: float, n: 'Optional[int]', seq: list, *, "
               "steps, warm: bool):\n    return x\n")
        d = extract_jit_decl(src, "f")
        assert d.static_args == ["n", "steps", "t0", "warm"]
        assert d.params == ["x", "t0", "n", "seq", "steps", "warm"]

    def test_extracts_nested_and_methods(self):
        src = ("class Launcher:\n"
               "    def __call__(self, s, *, active=None):\n"
               "        return s\n"
               "def maker():\n"
               "    def merge(prob, n_real: int | None = None):\n"
               "        return prob\n"
               "    return merge\n")
        assert extract_jit_decl(src, "Launcher.__call__").static_args == \
            ["active"]
        assert extract_jit_decl(src, "maker.merge").static_args == \
            ["n_real"]

    def test_missing_anchor_raises(self):
        with pytest.raises(LookupError):
            extract_jit_decl("def f():\n    pass\n", "g")
        with pytest.raises(LookupError):
            extract_jit_decl("class f:\n    pass\n", "f")

    @pytest.mark.parametrize("module,qualname,expect_static", [
        ("solver/resident.py", "merge_delta", ["first_valid", "n_real"]),
        ("solver/sharded.py", "anneal_sharded",
         ["adaptive", "block", "draws", "exchange_every", "init_state",
          "ladder", "mesh", "n_real", "proposals_per_step", "return_stats",
          "return_sweeps", "steps", "t0", "t1", "trace_blocks"]),
    ])
    def test_real_anchors_resolve(self, module, qualname, expect_static):
        path = PKG / module
        d = extract_jit_decl(path.read_text(), qualname, str(path))
        assert d.static_args == expect_static


# --------------------------------------------------------------------------
# hygiene: FJ rules fire on broken worlds, stay silent on the tree
# --------------------------------------------------------------------------

_HOT = ("import os, time\nimport numpy as np\nimport torch\n"
        "# fleet-audit: hot-path\n")


def _codes(src, **kw):
    return [d.code for d in hygiene_lint_source(src, "t.py", **kw)]


class TestHygieneRules:
    @pytest.mark.parametrize("method", ["item", "tolist", "cpu", "numpy"])
    def test_fj001_host_read_in_a_hot_dispatch(self, method):
        src = _HOT + f"def f(x, *, steps: int):\n    return x.{method}()\n"
        assert _codes(src) == ["FJ001"]

    def test_fj002_cast_on_a_tensor_but_not_a_scalar(self):
        src = _HOT + ("def f(x, t0: float, *, flag):\n"
                      "    a = float(x)\n"
                      "    b = float(t0) + int(flag)\n"   # declared knobs
                      "    c = int(x.shape[0])\n"         # host metadata
                      "    return a + b + c\n")
        assert _codes(src) == ["FJ002"]

    def test_fj003_numpy_compute_but_not_dtypes(self):
        src = _HOT + ("def f(x):\n"
                      "    a = np.sum(x)\n"
                      "    dt = np.float32\n"
                      "    return a\n")
        assert _codes(src) == ["FJ003"]

    def test_fj004_env_read(self):
        src = _HOT + ("def f(x):\n"
                      "    if os.environ.get('FLEET_X'):\n"
                      "        return x\n"
                      "    return x + int(os.getenv('Y') or 0)\n")
        assert _codes(src) == ["FJ004", "FJ004"]

    def test_a_kernel_launch_makes_a_hot_dispatch(self):
        """A function whose own body calls _ext.launch or _ext.raise_on
        (the counted launch points) is hot without a marker."""
        for launch in ("_ext.launch('k3', 'ff', dev, x)",
                       "_ext.raise_on('k1', self.fn(x))"):
            src = ("from . import _ext\n"
                   f"def f(self, x, dev):\n    {launch}\n"
                   "    return x.item()\n")
            assert _codes(src) == ["FJ001"], launch

    def test_a_registered_root_is_hot(self):
        src = "def merge(x):\n    return x.tolist()\n"
        assert _codes(src) == []
        assert _codes(src, module="m", hot_roots={"m:merge"}) == ["FJ001"]

    def test_nested_defs_inside_a_hot_dispatch_are_hot(self):
        src = _HOT + ("def outer(x):\n"
                      "    def body(y):\n"
                      "        return np.square(y)\n"
                      "    return body(x)\n")
        assert _codes(src) == ["FJ003"]

    def test_nested_hot_roots_not_double_reported(self):
        src = _HOT + ("def outer(x):\n"
                      "    # fleet-audit: hot-path\n"
                      "    def inner(y):\n"
                      "        return y.item()\n"
                      "    return inner(x)\n")
        assert _codes(src) == ["FJ001"]

    @pytest.mark.parametrize("code,line", [
        ("FJ001", "    return x.item()"),
        ("FJ002", "    return float(x)"),
        ("FJ003", "    return np.sum(x)"),
        ("FJ004", "    return os.getenv('Y')"),
    ])
    def test_noqa_suppresses(self, code, line):
        src = _HOT + "def f(x):\n" + line + "\n"
        assert _codes(src) == [code]
        assert _codes(src.rstrip("\n") + f"  # noqa: {code}\n") == []
        assert _codes(src.rstrip("\n") + "  # noqa\n") == []

    def test_plain_functions_not_hot(self):
        src = ("import numpy as np\nimport os\n"
               "def f(x):\n"
               "    return np.sum(x.numpy()) + int(os.getenv('Y') or 0)\n")
        assert _codes(src) == []

    def test_severities_and_function_ride_lint_machinery(self):
        src = _HOT + "def f(x):\n    return x.item()\n"
        d = hygiene_lint_source(src, "t.py")[0]
        assert d.severity is Severity.ERROR
        assert d.file == "t.py" and d.line == 6 and d.function == "f"
        assert "t.py:6:" in d.format()

    @pytest.mark.parametrize("src", [
        "import time\nasync def h(req):\n    time.sleep(1)\n    return req\n",
        "from time import sleep\nasync def h(req):\n    sleep(1)\n"
        "    return req\n",
        "from subprocess import run\nasync def h(req):\n    run(['ls'])\n"
        "    return req\n",
        "import time\nasync def h(req):\n    def helper():\n"
        "        time.sleep(1)\n    helper()\n    return req\n",
        "import requests\nasync def outer(req):\n    async def inner():\n"
        "        requests.get('http://x')\n    await inner()\n",
        "async def h(self):\n    with self._lock:\n"
        "        await self.flush()\n",
        "def f(:\n",
    ])
    def test_fj005_fj006_equal_the_reference(self, src):
        """The reference's FJ005/FJ006 sources: the same codes, lines and
        columns from both packages."""
        def key(diags):
            return [(d.code, d.line, d.col, d.severity.value, d.function)
                    for d in diags]
        assert key(hygiene_lint_source(src, "t.py")) == \
            key(ref_hygiene_source(src, "t.py"))


# --------------------------------------------------------------------------
# dataflow: FJ007, FJ008, FJ010 — every canary fails, the clean idioms pass
# --------------------------------------------------------------------------

_REGISTRY = ("import numpy as np\nimport torch\n"
             "from .contracts import KernelContract\n"
             "def merge(prob, assignment, rows):\n"
             "    prob.demand.index_copy_(0, rows, rows.float())\n"
             "    assignment.fill_(0)\n"
             "REGISTRY = [KernelContract(name='m', module='t', "
             "qualname='merge', cases=None,\n"
             "    must_write_in_place=('prob.demand', 'assignment'))]\n")


def _df(src):
    return dataflow_lint_source(src, "t.py")


class TestDataflowCanaries:
    def test_fj007_view_read_after_the_in_place_merge(self):
        diags = _df(_REGISTRY + (
            "def churn(prob, a, rows):\n"
            "    host = a.numpy()\n"
            "    merge(prob, a, rows)\n"
            "    return host.sum()\n"))
        assert [d.code for d in diags] == ["FJ007"]
        d = diags[0]
        assert d.function == "churn" and d.severity is Severity.ERROR
        assert "`host`" in d.message and "`a`" in d.message

    def test_fj007_through_a_method_that_merges(self):
        """The resident idiom: apply_delta merges its own slots in place,
        so a view of resident.assignment taken before it is stale."""
        diags = _df(_REGISTRY + (
            "class Resident:\n"
            "    def apply_delta(self, rows):\n"
            "        merge(self.prob, self.assignment, rows)\n"
            "def solve(resident, rows):\n"
            "    seed = np.asarray(resident.assignment.cpu())\n"
            "    resident.apply_delta(rows)\n"
            "    return seed[:3]\n"))
        assert [d.code for d in diags] == ["FJ007"]
        assert diags[0].function == "solve"
        assert "resident.assignment" in diags[0].message

    def test_fj007_view_of_a_slot_escapes(self):
        diags = _df(_REGISTRY + (
            "class Resident:\n"
            "    def apply_delta(self, rows):\n"
            "        merge(self.prob, self.assignment, rows)\n"
            "    def snapshot(self):\n"
            "        return self.assignment.numpy()\n"))
        assert [d.code for d in diags] == ["FJ007"]
        assert diags[0].function == "Resident.snapshot"

    def test_fj008_tensor_branch_one_call_deep(self):
        diags = _df("# fleet-audit: hot-path\n"
                    "def step(x, *, steps: int):\n"
                    "    return _decide(x)\n"
                    "def _decide(v):\n"
                    "    if v.sum() > 0:\n"
                    "        return 1\n"
                    "    return 0\n")
        assert [d.code for d in diags] == ["FJ008"]
        d = diags[0]
        assert d.function == "_decide" and d.severity is Severity.ERROR
        assert "`x`" in d.message and "step" in d.message

    def test_fj010_deep_host_sync(self):
        diags = _df("# fleet-audit: hot-path\n"
                    "def step(x):\n"
                    "    y = x.item()\n"             # depth 0: hygiene's
                    "    return _stat(x) + y\n"
                    "def _stat(v):\n"
                    "    return v.max().tolist()\n")
        assert [d.code for d in diags] == ["FJ010"]
        d = diags[0]
        assert d.function == "_stat" and "hot dispatch" in d.message

    def test_fj010_through_a_bound_launcher(self):
        """step = make(x) returns a Launcher instance: step(y) is
        Launcher.__call__ (the K1/K7 bound-launcher idiom)."""
        diags = _df("class Launcher:\n"
                    "    def __init__(self, x):\n"
                    "        self.x = x\n"
                    "    def __call__(self, u):\n"
                    "        return float(u)\n"
                    "def make(x):\n"
                    "    return Launcher(x)\n"
                    "# fleet-audit: hot-path\n"
                    "def anneal(x, u):\n"
                    "    step = make(x)\n"
                    "    return step(u)\n")
        assert [(d.code, d.function) for d in diags] == \
            [("FJ010", "Launcher.__call__")]

    def test_clean_idioms_pass(self):
        """A copy before the merge, `is None` checks, declared scalars,
        tensor metadata, a read after the dispatch, and the plain
        versions' CPU branch: no finding."""
        assert _df(_REGISTRY + (
            "def churn(prob, a, rows):\n"
            "    host = np.array(a.numpy(), copy=True)\n"
            "    merge(prob, a, rows)\n"
            "    return host.sum()\n"
            "# fleet-audit: hot-path\n"
            "def step(x, t0: float, sticky=None):\n"
            "    if sticky is not None and t0 > 0 and x.shape[0]:\n"
            "        return _plainish(x)\n"
            "    return _plainish(x)\n"
            "def _plainish(v):\n"
            "    if v.device.type == 'cpu':\n"
            "        return _plain(v)\n"
            "    return v\n"
            "def _plain(v):\n"
            "    return v.tolist()\n")) == []

    @pytest.mark.parametrize("code,src", [
        ("FJ008", "def _decide(x):\n"
                  "    if x > 0:{noqa}\n"
                  "        return 1\n"
                  "    return 0\n"
                  "# fleet-audit: hot-path\n"
                  "def step(x):\n"
                  "    return _decide(x)\n"),
        ("FJ010", "def _stat(v):\n"
                  "    return v.item(){noqa}\n"
                  "# fleet-audit: hot-path\n"
                  "def step(x):\n"
                  "    return _stat(x)\n"),
        ("FJ007", _REGISTRY.replace("{", "{{").replace("}", "}}")
         + "def churn(prob, a, rows):\n"
           "    host = a.numpy()\n"
           "    merge(prob, a, rows)\n"
           "    return host.sum(){noqa}\n"),
    ])
    def test_noqa_suppresses_dataflow(self, code, src):
        assert [d.code for d in _df(src.format(noqa=""))] == [code]
        assert _df(src.format(noqa=f"  # noqa: {code}")) == []

    def test_syntax_error_returns_nothing(self):
        assert _df("def f(:\n") == []


class TestCallGraphResolution:
    """The call-graph legs the interprocedural rules stand on: the
    reference's fixtures resolve to the same edges in both packages, and
    each leg carries an FJ008 probe under a hot dispatch here."""

    SOURCES = {
        "local_type": ("import jax\n"
                       "class Policy:\n"
                       "    def decide(self, x):\n"
                       "        if x > 0:\n"
                       "            return 1\n"
                       "        return 0\n"
                       "@jax.jit\n"
                       "def step(x):\n"
                       "    p = Policy()\n"
                       "    return p.decide(x)\n"),
        "bases": ("import jax\n"
                  "class Base:\n"
                  "    def decide(self, x):\n"
                  "        if x > 0:\n"
                  "            return 1\n"
                  "        return 0\n"
                  "class Derived(Base):\n"
                  "    pass\n"
                  "@jax.jit\n"
                  "def step(x):\n"
                  "    p = Derived()\n"
                  "    return p.decide(x)\n"),
        "partial": ("import jax\n"
                    "from functools import partial\n"
                    "def _decide(x):\n"
                    "    if x > 0:\n"
                    "        return 1\n"
                    "    return 0\n"
                    "_bound = partial(_decide)\n"
                    "@jax.jit\n"
                    "def step(x):\n"
                    "    return _bound(x)\n"),
        "decorator": ("import functools\nimport jax\n"
                      "@functools.lru_cache(maxsize=None)\n"
                      "def _decide(x):\n"
                      "    if x > 0:\n"
                      "        return 1\n"
                      "    return 0\n"
                      "@jax.jit\n"
                      "def step(x):\n"
                      "    return _decide(x)\n"),
        "recursion": ("import jax\n"
                      "def _even(x):\n"
                      "    if x > 0:\n"
                      "        return _odd(x)\n"
                      "    return 1\n"
                      "def _odd(x):\n"
                      "    return _even(x)\n"
                      "@jax.jit\n"
                      "def step(x):\n"
                      "    return _even(x)\n"),
    }
    PROBES = {"local_type": "Policy.decide", "bases": "Base.decide",
              "partial": "_decide", "decorator": "_decide",
              "recursion": "_even"}

    @staticmethod
    def _edges(build, path):
        g = build([str(path)])
        out = set()
        for fn in g.functions.values():
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    callee = g.resolve_call(fn, node)
                    if callee is not None:
                        out.add((fn.key, node.lineno, callee.key))
        return out

    @pytest.mark.parametrize("name", sorted(SOURCES))
    def test_same_edges_as_the_reference(self, name, tmp_path):
        path = tmp_path / "t.py"
        path.write_text(self.SOURCES[name])
        edges = self._edges(build_graph, path)
        assert edges and edges == self._edges(ref_build_graph, path)

    @pytest.mark.parametrize("name", sorted(SOURCES))
    def test_fj008_probe_under_a_hot_dispatch(self, name):
        src = self.SOURCES[name].replace("@jax.jit\n",
                                         "# fleet-audit: hot-path\n")
        assert [(d.code, d.function) for d in _df(src)] == \
            [("FJ008", self.PROBES[name])]


class TestAuditBaseline:
    """The accepted-findings ledger, each case in both packages: count-
    capped suppression keyed rule+path+function, stale entries surfaced,
    write -> load roundtrip stable, malformed files refused."""

    @staticmethod
    def _diag(mod, code="FJ010", file="a.py", function="f"):
        diag = mod.__name__.rsplit(".", 2)[0] + ".lint.diagnostics"
        Diagnostic = __import__(diag, fromlist=["Diagnostic"]).Diagnostic
        sev = __import__(diag, fromlist=["Severity"]).Severity
        return Diagnostic(code=code, severity=sev.WARNING, message="m",
                          file=file, line=1, col=1, function=function)

    @pytest.fixture(params=[port_baseline, ref_baseline],
                    ids=["port", "reference"])
    def mod(self, request):
        return request.param

    def test_count_capped_suppression(self, mod):
        b = mod.Baseline(entries={("FJ010", "a.py", "f"): 2})
        kept, suppressed, stale = mod.apply_baseline(
            [self._diag(mod), self._diag(mod), self._diag(mod)], b)
        assert suppressed == 2 and len(kept) == 1 and stale == []

    def test_stale_entries_reported(self, mod):
        b = mod.Baseline(entries={("FJ010", "gone.py", "g"): 1})
        kept, suppressed, stale = mod.apply_baseline([self._diag(mod)], b)
        assert suppressed == 0 and len(kept) == 1
        assert stale == [("FJ010", "gone.py", "g")]

    def test_key_mismatch_never_suppresses(self, mod):
        b = mod.Baseline(entries={("FJ007", "a.py", "f"): 5,
                                  ("FJ010", "a.py", "other"): 5,
                                  ("FJ010", "b.py", "f"): 5})
        kept, suppressed, _ = mod.apply_baseline([self._diag(mod)], b)
        assert suppressed == 0 and len(kept) == 1

    def test_write_load_roundtrip(self, mod, tmp_path):
        path = str(tmp_path / "baseline.json")
        mod.write_baseline([self._diag(mod), self._diag(mod),
                            self._diag(mod, function="g")], path)
        assert mod.load_baseline(path).entries == {
            ("FJ010", "a.py", "f"): 2, ("FJ010", "a.py", "g"): 1}

    def test_malformed_baseline_raises(self, mod, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("[]")
        with pytest.raises(ValueError):
            mod.load_baseline(str(p))
        p.write_text('{"entries": [{"path": "a.py"}]}')
        with pytest.raises(ValueError):
            mod.load_baseline(str(p))

    def test_update_keeps_each_entrys_reason(self, tmp_path):
        """The port's ledger carries a reason per entry; a rewrite keeps
        the reason of every entry it writes again."""
        path = str(tmp_path / "baseline.json")
        shutil.copy(default_baseline_path(), path)
        why = load_baseline(path).why
        assert why and all(why.values())
        diags = [self._diag(port_baseline, code=r, file=p, function=f)
                 for (r, p, f), c in load_baseline(path).entries.items()
                 for _ in range(c)]
        write_baseline(diags, path)
        assert load_baseline(path).why == why


# --------------------------------------------------------------------------
# the port's tree holds its own bar
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_diags():
    hyg = hygiene_lint_paths([str(PKG / "solver"), str(PKG / "cp")],
                             rel_to=str(REPO))
    return hyg, dataflow_lint_paths([str(PKG)], rel_to=str(REPO))


class TestHygieneTreeClean:
    def test_solver_and_cp_are_clean_modulo_the_baseline(self, tree_diags):
        hyg, _ = tree_diags
        kept, _n, _stale = apply_baseline(
            hyg, load_baseline(default_baseline_path()))
        assert kept == [], "\n".join(d.format() for d in kept)


class TestDataflowTreeClean:
    def test_clean_modulo_the_baseline(self, tree_diags):
        _, df = tree_diags
        kept, _n, _stale = apply_baseline(
            df, load_baseline(default_baseline_path()))
        assert kept == [], "\n".join(d.format() for d in kept)

    def test_baseline_has_no_stale_entry_and_each_a_reason(self,
                                                           tree_diags):
        """The ledger excuses exactly what the tree holds: the deliberate
        syncs under the hot dispatches (the map of where the host paces
        the card), each with its reason."""
        hyg, df = tree_diags
        base = load_baseline(default_baseline_path())
        kept, suppressed, stale = apply_baseline(hyg + df, base)
        assert kept == [] and stale == []
        assert suppressed == sum(base.entries.values())
        assert set(base.why) == set(base.entries)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

class TestAuditCli:
    def test_audit_all_strict_sarif(self, capsys):
        rc = fleet_main(["--device", "cpu", "audit", "all", "--strict",
                         "--baseline", default_baseline_path(),
                         "--format", "sarif"])
        out = capsys.readouterr().out
        assert rc == 0
        doc = json.loads(out)
        assert doc["version"] == "2.1.0"
        assert [tool["name"] for r in doc["runs"]
                for tool in r["tool"].values()] == [
            "fleet-audit-kernels", "fleet-audit-hygiene",
            "fleet-audit-dataflow"]
        assert all(r["results"] == [] for r in doc["runs"])

    @pytest.mark.parametrize("verb", ["kernels", "all"])
    def test_audit_without_cuda_is_an_error(self, verb, monkeypatch,
                                            capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        rc = fleet_main(["audit", verb])
        err = capsys.readouterr().err
        assert rc == 1 and err.startswith("error: ")
        assert "CUDA" in err

    def test_update_writes_a_golden_that_loads_back_equal(self, tmp_path,
                                                          report, capsys):
        path = tmp_path / "contract.json"
        assert fleet_main(["--device", "cpu", "audit", "kernels",
                           "--update", "--contract", str(path)]) == 0
        doc = json.loads(path.read_text())
        assert contract_diff(report, doc) == []
        assert doc == _pinned()
        assert fleet_main(["--device", "cpu", "audit", "kernels",
                           "--contract", str(path)]) == 0
        assert "launch contract holds" in capsys.readouterr().out

    def test_missing_contract_file_exits_2(self, tmp_path):
        assert fleet_main(["--device", "cpu", "audit", "kernels",
                           "--contract", str(tmp_path / "none.json")]) == 2
