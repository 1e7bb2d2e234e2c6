"""The port's `fleet` CLI (fleetflow_tpu_torch.cli) against the
reference's (fleetflow_tpu.cli), on the CPU.

- the same argv through both packages' ``main`` on copies of one project:
  on the host paths (``validate``, ``lint``, ``init``, ``up --dry-run``,
  the mock backend's ``up``/``ps``/``down``, ``solve --host``,
  ``chaos list``/``run --host``, ``plan simulate --host``, ``events``,
  ``solve trace``, the bundled examples) stdout and stderr are byte-equal,
  apart from the normalisations written below (the project's path and
  host wall times);
- the card path: ``fleet --device cpu solve`` on a fleet large enough for
  ``pick_scheduler`` to pick the card solver is feasible with 0
  violations in both packages, its line equal to the reference's apart
  from the source (``gpu-anneal``/``tpu-anneal``), the ms and the
  assignment, which the port's host ``verify`` holds; without CUDA and
  without ``--device cpu``, ``solve``, ``chaos run``, ``plan simulate``
  and ``cp registry solve`` exit 1 with the DeviceUnavailable message and
  print no placement;
- tests/test_cli_mcp.py's CLI cases, tests/test_wizard_update.py and the
  CLI cases of tests/test_flightdeck.py on the port, the parser's help
  equal to the reference's apart from the reworded strings;
- the client: tests/test_cp.py's TestSyncCpClient and test_auth_idp.py's
  TestDeviceFlow on the port, credentials across packages, and each
  package's ``CpClient`` against the other's server (below the
  reference's 1 MiB frame cap).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import re
import shutil
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from torch_wire_kit import PORT, PORT_CARD, REF, run, start_cp

REF_ROOT, PORT_ROOT = "fleetflow_tpu", "fleetflow_tpu_torch"
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NO_CUDA = "needs a CUDA device"
CHAOS = ["--seed", "7", "--services", "60", "--nodes", "10",
         "--stages", "2"]


def cli(root: str):
    return importlib.import_module(f"{root}.cli.main")


def fleet(root: str, argv, capsys):
    """(rc, stdout, stderr) of `fleet argv` through `root`'s main."""
    capsys.readouterr()
    try:
        rc = cli(root).main(list(argv))
    except SystemExit as e:
        rc = ("exit", e.code)
    out = capsys.readouterr()
    return rc, out.out, out.err


# the normalisations of the host paths: the project's directory, and the
# host wall times the placer and the engine print
_MS = re.compile(r"\d+\.\d+ms")
_S = re.compile(r"in \d+\.\d+s\b")


def norm(text: str, *paths) -> str:
    for p in paths:
        if str(p):
            text = text.replace(str(p), "<dir>")
    return _S.sub("in <s>s", _MS.sub("<ms>ms", text))


def copies(tmp_path, src: Path) -> dict:
    """The project at `src` copied once for each package."""
    out = {}
    for root in (REF_ROOT, PORT_ROOT):
        dst = tmp_path / root
        shutil.copytree(src, dst)
        out[root] = dst
    return out


def parity(capsys, dirs: dict, argv_of, host_flag: bool = False):
    """Run argv_of(dir) in both packages on their copies; assert equal
    normalised rc, stdout and stderr. `host_flag` adds the port's
    ``--host`` to a verb whose reference places on the host by default."""
    got = {}
    for root, d in dirs.items():
        argv = list(argv_of(d))
        if host_flag and root == PORT_ROOT:
            argv.append("--host")
        rc, out, err = fleet(root, argv, capsys)
        got[root] = (rc, norm(out, d), norm(err, d))
    assert got[PORT_ROOT] == got[REF_ROOT]
    return got[PORT_ROOT]


# --------------------------------------------------------------------------
# host paths, byte-equal
# --------------------------------------------------------------------------

class TestHostPathParity:
    def test_init_then_up_dry_run(self, tmp_path, capsys):
        dirs = {r: tmp_path / r for r in (REF_ROOT, PORT_ROOT)}
        parity(capsys, dirs, lambda d: ["--project-root", str(d), "init",
                                        "--name", "demo"])
        assert (dirs[PORT_ROOT] / ".fleetflow" / "fleet.kdl").read_text() \
            == (dirs[REF_ROOT] / ".fleetflow" / "fleet.kdl").read_text()
        rc, _, _ = parity(capsys, dirs, lambda d: [
            "--project-root", str(d), "init"])
        assert rc == 1
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "--project-root", str(d), "up", "--dry-run"])
        assert rc == 0 and "demo" in out and "nginx:alpine" in out

    @pytest.mark.parametrize("verb", [
        ["up", "local"], ["ps", "local"], ["down", "local"],
        ["restart", "local", "--local"]])
    def test_mock_backend_verbs(self, verb, project, tmp_path, capsys):
        root, _ = project
        dirs = copies(tmp_path, root)
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "--project-root", str(d), "--mock", *verb])
        assert rc == 0

    def test_up_builds_services_with_build_config(self, project, capsys,
                                                  monkeypatch):
        """A service with build{} is built before create/start, under the
        tag the engine creates from (test_cli_mcp.py's case, on the
        port)."""
        root, write = project
        (root / "appdir").mkdir()
        (root / "appdir" / "Dockerfile").write_text("FROM scratch\n")
        write("services/built.kdl", '''
service "built" {
    build { context "appdir" }
}
stage "b" { service "built" }
''')
        from fleetflow_tpu_torch.build import builder as bmod
        from fleetflow_tpu_torch.runtime.backend import MockBackend

        class DockerStandIn:
            # not a MockBackend instance, so the build step runs
            def __init__(self):
                self._m = MockBackend(auto_pull=True)

            def __getattr__(self, name):
                return getattr(self._m, name)
        built = []
        monkeypatch.setattr(cli(PORT_ROOT), "_backend",
                            lambda a: DockerStandIn())
        monkeypatch.setattr(
            bmod.ImageBuilder, "build",
            lambda self, resolved, on_line=None: built.append(resolved.tag)
            or resolved.tag)
        rc, _, _ = fleet(PORT_ROOT, ["--project-root", str(root), "up", "b"],
                         capsys)
        assert rc == 0 and built and built[0].startswith("built")

    def test_dry_run_masks_secrets(self, project, tmp_path, capsys):
        root, write = project
        write("services/secret.kdl", '''
service "vault" {
    image "vault"
    env { VAULT_TOKEN "super-secret-token-value" }
}
stage "sec" { service "vault" }
''')
        dirs = copies(tmp_path, root)
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "--project-root", str(d), "up", "sec", "--dry-run"])
        assert rc == 0 and "super-secret-token-value" not in out
        assert "VAULT_TOKEN=su" in out

    @pytest.mark.parametrize("argv", [
        ["validate"], ["lint"], ["lint", "--strict"],
        ["lint", "--format", "json"], ["lint", "--format", "sarif"],
        ["solve", "local", "--host"], ["solve", "local", "--host", "--json"],
        ["solve", "-s", "local", "--host"]])
    def test_util_verbs(self, argv, project, tmp_path, capsys):
        root, _ = project
        dirs = copies(tmp_path, root)
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "--project-root", str(d), *argv])
        assert rc == 0
        if argv[0] == "solve":
            assert "host-greedy" in out

    def test_missing_config_exit_code(self, tmp_path, capsys):
        dirs = {r: tmp_path / r for r in (REF_ROOT, PORT_ROOT)}
        for d in dirs.values():
            d.mkdir()
        for verb in (["up"], ["lint", "--format", "json"], ["solve"]):
            rc, _, err = parity(capsys, dirs, lambda d: [
                "--project-root", str(d), *verb])
            assert rc in (2, ("exit", 2)) and "no fleet config" in err

    @pytest.mark.parametrize("example,argv", [
        ("hello-world", ["--mock", "up", "local"]),
        ("hello-world", ["solve", "live"]),
        ("hello-world", ["solve", "live", "--json"]),
        ("production", ["validate"]),
        ("production", ["lint", "--format", "json"])])
    def test_bundled_examples(self, example, argv, capsys):
        d = EXAMPLES / example
        rc, out, _ = parity(capsys, {REF_ROOT: d, PORT_ROOT: d},
                            lambda d: ["--project-root", str(d), *argv])
        assert rc == 0

    def test_chaos_list_and_schedule(self, capsys):
        parity(capsys, {REF_ROOT: "", PORT_ROOT: ""},
               lambda d: ["chaos", "list"])
        rc, out, _ = parity(capsys, {REF_ROOT: "", PORT_ROOT: ""}, lambda d: [
            "chaos", "run", "--scenario", "rolling-kill", *CHAOS,
            "--show-schedule"])
        assert rc == 0 and out

    def test_chaos_run_host_equals_the_reference(self, tmp_path, capsys):
        """`fleet chaos run --host` is the reference's world: the same
        lines, digest, report, TSDB capture and trace, but for the trace's
        and the report's wall-clock SLO baseline (host latencies, outside
        every digest)."""
        dirs = {r: tmp_path / r for r in (REF_ROOT, PORT_ROOT)}
        for d in dirs.values():
            d.mkdir()
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "chaos", "run", "--scenario", "rolling-kill-selfheal", *CHAOS,
            "--json", str(d / "report.json"),
            "--tsdb-out", str(d / "tsdb.json"),
            "--record-trace", str(d / "trace.jsonl")], host_flag=True)
        assert rc == 0 and "all invariants hold" in out
        a, b = (json.loads((dirs[r] / "report.json").read_text())
                for r in (REF_ROOT, PORT_ROOT))
        a.pop("slo"), b.pop("slo")
        assert a == b
        assert (dirs[PORT_ROOT] / "tsdb.json").read_text() == \
            (dirs[REF_ROOT] / "tsdb.json").read_text()

        def lines(root):
            out = [json.loads(ln) for ln in
                   (dirs[root] / "trace.jsonl").read_text().splitlines()]
            out[-1]["baseline"].pop("wall", None)
            return out
        assert lines(PORT_ROOT) == lines(REF_ROOT)

    def test_chaos_expect_digest(self, capsys):
        rc, out, _ = fleet(PORT_ROOT, ["chaos", "run", "--scenario",
                                       "flap-storm", *CHAOS, "--host"],
                           capsys)
        digest = re.search(r"digest ([0-9a-f]{16,})", out).group(1)
        assert fleet(PORT_ROOT, ["chaos", "run", "--scenario", "flap-storm",
                                 *CHAOS, "--host", "--expect-digest",
                                 digest], capsys)[0] == 0
        rc, out, _ = fleet(PORT_ROOT, ["chaos", "run", "--scenario",
                                       "flap-storm", *CHAOS, "--host",
                                       "--expect-digest", "0" * 64], capsys)
        assert rc == 1 and "DIGEST MISMATCH" in out

    def test_plan_simulate_host_equals_the_reference(self, tmp_path, capsys):
        """Both packages replay one recorded trace against the example's
        proposal: byte-equal reports."""
        trace = tmp_path / "traffic.jsonl"
        rc, _, _ = fleet(REF_ROOT, ["chaos", "run", "--scenario",
                                    "diurnal-hotspot", *CHAOS,
                                    "--record-trace", str(trace)], capsys)
        assert rc == 0
        flow = EXAMPLES / "plan-simulate" / "flow.kdl"
        dirs = {r: tmp_path / r for r in (REF_ROOT, PORT_ROOT)}
        for d in dirs.values():
            d.mkdir()
        rc, out, _ = parity(capsys, dirs, lambda d: [
            "plan", "simulate", str(flow), "--trace", str(trace),
            "--json", str(d / "plan.json")], host_flag=True)
        assert rc == 0 and "proposal holds the recorded SLOs" in out
        a, b = (json.loads((dirs[r] / "plan.json").read_text())
                for r in (REF_ROOT, PORT_ROOT))
        a.pop("wall_streams"), b.pop("wall_streams")
        assert a == b

    def test_events_and_solve_trace(self, tmp_path, monkeypatch, capsys):
        """One flight-recorder file, written by the port's solves, read by
        both packages' `events` and `solve trace` (test_flightdeck.py's
        CLI cases)."""
        from fleetflow_tpu_torch.lower.tensors import synthetic_problem
        from fleetflow_tpu_torch.obs.trace import flight_recorder
        from fleetflow_tpu_torch.solver import solve
        path = tmp_path / "flight.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(path))
        pt = synthetic_problem(60, 12, seed=2, port_fraction=0.3)
        solve(pt, steps=16, adaptive=True, device="cpu")
        solve(pt, steps=16, adaptive=True, seed=9, device="cpu")
        flight_recorder().close()
        same = {REF_ROOT: "", PORT_ROOT: ""}
        rc, out, _ = parity(capsys, same, lambda d: [
            "solve", "trace", "--last", "1"])
        assert rc == 0 and "seed/prologue" in out
        assert out.count("solve ts=") == 1
        assert parity(capsys, same, lambda d: [
            "solve", "trace", "--json"])[0] == 0
        rc, out, _ = parity(capsys, same, lambda d: ["events"])
        assert rc == 0 and "solve" in out
        monkeypatch.delenv("FLEET_TRACE_FILE")
        assert parity(capsys, same, lambda d: ["solve", "trace"])[0] == 2
        assert parity(capsys, same, lambda d: ["events"])[0] == 2


# --------------------------------------------------------------------------
# the card path
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_project(tmp_path_factory):
    """A fleetgen fleet of 122 rows on 12 servers as a two-file project:
    S x N = 1,464, so pick_scheduler gives it the card solver."""
    from fleetflow_tpu_torch.lower import fleetgen
    root = tmp_path_factory.mktemp("cardproj")
    cfg = root / ".fleetflow"
    cfg.mkdir()
    (cfg / "fleet.kdl").write_text(fleetgen.generate_fleet_kdl(
        "t0", 120, seed=100, n_nodes_hint=12, port_base=10000))
    (cfg / "cloud.kdl").write_text(fleetgen.generate_servers_kdl(12, seed=7))
    return root


_HEAD = re.compile(r"^solved (\d+) services x (\d+) nodes via (\S+) in "
                   r"[\d.]+ms \(feasible=(\w+), violations=(\d+)\)$")


def check_assignment(root, assignment: dict) -> None:
    """The printed assignment, re-lowered by the port, holds its host
    verify: every row on a node of the stage, 0 violations."""
    from fleetflow_tpu_torch.core.loader import \
        load_project_from_root_with_stage
    from fleetflow_tpu_torch.lower.tensors import lower_stage
    from fleetflow_tpu_torch.solver.repair import verify
    pt = lower_stage(load_project_from_root_with_stage(str(root), "prod"),
                     "prod")
    assert sorted(assignment) == sorted(pt.service_names)
    idx = {n: i for i, n in enumerate(pt.node_names)}
    raw = np.array([idx[assignment[s]] for s in pt.service_names])
    assert verify(pt, raw)["total"] == 0


class TestCardPath:
    def test_solve_on_the_card_solver(self, card_project, capsys):
        argv = ["--project-root", str(card_project), "solve", "-s", "prod",
                "--json"]
        rc, out, err = fleet(PORT_ROOT, ["--device", "cpu", *argv], capsys)
        assert rc == 0, err
        head, body = out.split("\n", 1)
        m = _HEAD.match(head)
        assert m and m.group(3) == "gpu-anneal", head
        assert (m.group(4), m.group(5)) == ("True", "0")
        check_assignment(card_project, json.loads(body))
        ref_rc, ref_out, _ = fleet(REF_ROOT, argv, capsys)
        ref_head, ref_body = ref_out.split("\n", 1)
        rm = _HEAD.match(ref_head)
        assert ref_rc == 0 and rm.group(3) == "tpu-anneal"
        assert m.group(1, 2, 4, 5) == rm.group(1, 2, 4, 5)
        assert sorted(json.loads(ref_body)) == sorted(json.loads(body))

    def test_solve_text_listing(self, card_project, capsys):
        rc, out, _ = fleet(PORT_ROOT, [
            "--device", "cpu", "--project-root", str(card_project), "solve",
            "prod"], capsys)
        assert rc == 0
        lines = out.splitlines()
        assert "via gpu-anneal" in lines[0]
        placed = {}
        for ln in lines[1:]:
            node, svcs = ln.strip().split(": ", 1)
            for s in svcs.split(", "):
                placed[s] = node
        check_assignment(card_project, placed)

    def test_solve_without_cuda_exits_1(self, card_project, capsys):
        rc, out, err = fleet(PORT_ROOT, [
            "--project-root", str(card_project), "solve", "-s", "prod",
            "--json"], capsys)
        assert rc == 1 and out == ""
        assert err.startswith("error: ") and NO_CUDA in err

    def test_small_stage_stays_on_the_host_without_cuda(self, project,
                                                        capsys):
        # pick_scheduler's sizes: 3 services on one node is the host's
        root, _ = project
        rc, out, _ = fleet(PORT_ROOT, ["--project-root", str(root), "solve",
                                       "local"], capsys)
        assert rc == 0 and "via host-greedy" in out

    def test_chaos_run_on_the_card_scheduler(self, capsys):
        rc, out, err = fleet(PORT_ROOT, [
            "--device", "cpu", "chaos", "run", "--scenario",
            "rolling-kill-selfheal", *CHAOS], capsys)
        assert rc == 0, out + err
        assert "all invariants hold" in out

    def test_chaos_run_without_cuda_exits_1(self, capsys):
        rc, out, err = fleet(PORT_ROOT, [
            "chaos", "run", "--scenario", "rolling-kill-selfheal", *CHAOS],
            capsys)
        assert rc == 1 and NO_CUDA in err
        assert "all invariants hold" not in out and "events |" not in out

    def test_plan_simulate_on_the_card_scheduler(self, tmp_path, capsys):
        trace = tmp_path / "traffic.jsonl"
        assert fleet(PORT_ROOT, [
            "--device", "cpu", "chaos", "run", "--scenario",
            "diurnal-hotspot", *CHAOS, "--record-trace", str(trace)],
            capsys)[0] == 0
        flow = str(EXAMPLES / "plan-simulate" / "flow.kdl")
        rc, out, err = fleet(PORT_ROOT, ["--device", "cpu", "plan",
                                         "simulate", flow, "--trace",
                                         str(trace)], capsys)
        assert rc == 0, out + err
        assert "proposal holds the recorded SLOs" in out
        rc, out, err = fleet(PORT_ROOT, ["plan", "simulate", flow,
                                         "--trace", str(trace)], capsys)
        assert rc == 1 and NO_CUDA in err and "report digest" not in out

    def test_registry_solve(self, tmp_path, monkeypatch, capsys):
        from fleetflow_tpu_torch.lower import fleetgen
        chip_smoke.registry_write(fleetgen, str(tmp_path), 40, 30, fleets=3)
        monkeypatch.setenv("FLEET_REGISTRY",
                           str(tmp_path / "fleet-registry.kdl"))
        rc, out, err = fleet(PORT_ROOT, ["--device", "cpu", "cp",
                                         "registry", "solve"], capsys)
        assert rc == 0, err
        assert out.strip().endswith("feasible=True via gpu-anneal")
        ref_rc, ref_out, _ = fleet(REF_ROOT, ["cp", "registry", "solve"],
                                   capsys)
        assert ref_rc == 0
        assert ref_out.replace("tpu-anneal", "gpu-anneal") == out
        rc, out, err = fleet(PORT_ROOT, ["cp", "registry", "solve"], capsys)
        assert rc == 1 and out == "" and NO_CUDA in err
        parity(capsys, {REF_ROOT: "", PORT_ROOT: ""},
               lambda d: ["cp", "registry", "list"])

    def test_module_entry_point(self, card_project):
        """`python -m fleetflow_tpu_torch.cli`, as a user runs it."""
        import subprocess
        import sys
        repo = Path(__file__).resolve().parent.parent
        argv = [sys.executable, "-m", "fleetflow_tpu_torch.cli",
                "--project-root", str(card_project)]
        out = subprocess.run(argv + ["--device", "cpu", "solve", "-s",
                                     "prod"], capture_output=True,
                             text=True, timeout=120, cwd=str(repo))
        assert out.returncode == 0, out.stderr
        assert "via gpu-anneal" in out.stdout
        out = subprocess.run(argv + ["solve", "-s", "prod"],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(repo))
        assert out.returncode == 1 and NO_CUDA in out.stderr
        assert out.stdout == ""


# --------------------------------------------------------------------------
# the parser
# --------------------------------------------------------------------------

# subcommands whose help names the card, or that gained --host
_CHANGED = {"solve", "chaos", "plan"}


def _help(root, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        cli(root).main(list(argv))
    assert e.value.code == 0
    return capsys.readouterr().out


class TestParser:
    def test_help_and_missing_command(self, capsys):
        out = _help(PORT_ROOT, ["--help"], capsys)
        assert "fleetflow-tpu" in out and "--device" in out
        assert "audit" in out
        with pytest.raises(SystemExit):
            cli(PORT_ROOT).main([])

    @pytest.mark.parametrize("argv", [
        ["up"], ["down"], ["restart"], ["ps"], ["logs"], ["exec"],
        ["build"], ["deploy"], ["lint"], ["validate"], ["agent"],
        ["events"], ["init"], ["self-update"], ["mcp"], ["cp"],
        ["cp", "login"], ["cp", "token"], ["cp", "daemon"],
        ["cp", "registry"], ["cp", "placement"], ["admit"], ["slo"],
        ["top"], ["obs"], ["obs", "query"], ["chaos", "list"]])
    def test_subcommand_help_equals_the_reference(self, argv, capsys):
        assert _help(PORT_ROOT, [*argv, "--help"], capsys) == \
            _help(REF_ROOT, [*argv, "--help"], capsys)

    @pytest.mark.parametrize("argv", [["chaos", "run"], ["plan", "simulate"]])
    def test_host_flag_is_the_only_addition(self, argv, capsys):
        port = _help(PORT_ROOT, [*argv, "--help"], capsys)
        ref = _help(REF_ROOT, [*argv, "--help"], capsys)
        assert "--host" in port and "--host" not in ref
        port_flags = set(re.findall(r"--[a-z-]+", port))
        assert port_flags - set(re.findall(r"--[a-z-]+", ref)) == {"--host"}

    @pytest.mark.parametrize("verb", ["kernels", "hygiene", "dataflow",
                                      "all"])
    def test_audit_flags_are_the_references(self, verb, capsys):
        """The audit verbs take the reference's flags but
        `--allow-skips`: no contract needs more devices than one card."""
        port = _help(PORT_ROOT, ["audit", verb, "--help"], capsys)
        ref = _help(REF_ROOT, ["audit", verb, "--help"], capsys)
        flags = set(re.findall(r"--[a-z-]+", ref)) - {"--allow-skips"}
        assert set(re.findall(r"--[a-z-]+", port)) == flags

    def test_solve_help_names_the_gpu(self, capsys):
        out = _help(PORT_ROOT, ["--help"], capsys)
        assert "GPU placement preview" in out and "TPU" not in out

    def test_device_defaults_to_the_card(self):
        p = cli(PORT_ROOT).build_parser()
        assert p.parse_args(["solve"]).device is None
        assert p.parse_args(["--device", "cpu", "solve"]).device == "cpu"

    def test_cp_token_mints_scoped_identity(self, capsys):
        from fleetflow_tpu.cp.auth import TokenAuth as RefTokenAuth
        from fleetflow_tpu_torch.cp.auth import TokenAuth
        rc, out, _ = fleet(PORT_ROOT, ["cp", "token", "--secret", "s3",
                                       "--email", "agent@node-1"], capsys)
        assert rc == 0
        token = out.strip()
        for auth in (TokenAuth("s3"), RefTokenAuth("s3")):
            claims = auth.verify(token)
            assert claims.email == "agent@node-1"
            assert claims.permissions == ["write:agent"]

    def test_agent_parser_defaults(self):
        args = cli(PORT_ROOT).build_parser().parse_args(
            ["agent", "--slug", "n1", "--cp-port", "4517"])
        assert args.slug == "n1" and args.cp_port == 4517
        assert args.cpu == 2.0 and args.fn.__name__ == "cmd_agent"

    def test_podman_runtime_selected(self, monkeypatch, capsys):
        mod = cli(PORT_ROOT)
        captured = {}

        class FakeBackend:
            def __init__(self, binary="docker"):
                captured["binary"] = binary

            def ping(self):
                return False
        monkeypatch.setattr(mod, "DockerCliBackend", FakeBackend)
        monkeypatch.delenv("FLEET_BACKEND", raising=False)
        rc, _, err = fleet(PORT_ROOT, ["agent", "--runtime", "podman",
                                       "--slug", "n1"], capsys)
        assert rc == 3 and captured["binary"] == "podman"
        assert "podman unreachable" in err


class TestUtils:
    def test_equal_to_the_reference(self):
        from fleetflow_tpu.cli import utils as ref
        from fleetflow_tpu_torch.cli import utils as port
        env = {"FLEET_STAGE": "env"}
        for a, b in ((None, None), ("live", "f"), (None, "f")):
            assert port.determine_stage_name(a, b, env) == \
                ref.determine_stage_name(a, b, env)
            assert port.determine_stage_name(a, b, {}) == \
                ref.determine_stage_name(a, b, {})
        for k, v in (("DB_PASSWORD", "hunter2secret"), ("API_KEY", "abc"),
                     ("PLAIN", "visible"), ("TOKEN", ""),
                     ("SECRET_X", "a" * 40)):
            assert port.mask_sensitive(k, v) == ref.mask_sensitive(k, v)
        for s in ("30s", "5m", "500ms", "2h", "1d"):
            try:
                want = ref.parse_duration(s)
            except ValueError:
                with pytest.raises(ValueError):
                    port.parse_duration(s)
            else:
                assert port.parse_duration(s) == want
        assert port.filter_services(["a", "b", "c"], ["c", "a"]) == ["a", "c"]
        with pytest.raises(ValueError, match="unknown services"):
            port.filter_services(["a"], ["nope"])


class TestExecTty:
    @pytest.fixture
    def proj(self, tmp_path):
        cfg = tmp_path / ".fleetflow"
        cfg.mkdir()
        (cfg / "fleet.kdl").write_text(
            'project "p"\nservice "web" { image "nginx" }\n'
            'stage "local" { service "web" }\n')
        return tmp_path

    @pytest.mark.parametrize("extra,tty", [
        (["web"], True), (["web", "ls", "-la"], True),
        (["-i", "-t", "web", "psql"], True), (["web"], False)])
    def test_argv_equals_the_reference(self, extra, tty, monkeypatch, proj,
                                       capsys):
        import subprocess
        import sys as _sys
        calls = []
        monkeypatch.setattr(subprocess, "call",
                            lambda argv: calls.append(argv) or 0)
        monkeypatch.setattr(_sys.stdin, "isatty", lambda: tty)
        for root in (REF_ROOT, PORT_ROOT):
            rc, _, _ = fleet(root, ["--project-root", str(proj), "exec",
                                    *extra], capsys)
            assert rc == 0
        assert calls[0] == calls[1]

    def test_unknown_service_errors(self, proj, capsys):
        rc, _, err = fleet(PORT_ROOT, ["--project-root", str(proj), "exec",
                                       "nope"], capsys)
        assert rc == 1 and "not found" in err


# --------------------------------------------------------------------------
# the wizard and self-update (tests/test_wizard_update.py)
# --------------------------------------------------------------------------

def scripted(*answers):
    it = iter(answers)
    return lambda msg: next(it)


class TestWizard:
    def test_templates_and_paths_equal_the_reference(self):
        from fleetflow_tpu.cli import wizard as ref
        from fleetflow_tpu_torch.cli import wizard as port
        assert [t.name for t in port.TEMPLATES] == \
            [t.name for t in ref.TEMPLATES]
        assert port.CONFIG_PATHS == ref.CONFIG_PATHS
        for a, b in zip(port.TEMPLATES, ref.TEMPLATES):
            assert port.render_template(a, "demo") == \
                ref.render_template(b, "demo")

    @pytest.mark.parametrize("answers", [
        ("demo", "2", "2", "y"), ("", "", "", ""), ("demo", "q"),
        ("p", "9", "1", "2", "y"), ("x", "3", "1", "y")])
    def test_runs_equal_the_reference(self, answers, tmp_path):
        from fleetflow_tpu.cli.wizard import run_wizard as ref_run
        from fleetflow_tpu_torch.cli.wizard import run_wizard
        got = {}
        for name, fn in (("ref", ref_run), ("port", run_wizard)):
            d = tmp_path / name
            d.mkdir()
            lines = []
            target = fn(project_root=str(d), default_name="proj",
                        prompt_fn=scripted(*answers), print_fn=lines.append)
            text = target.read_text() if target is not None else None
            rel = target.relative_to(d) if target is not None else None
            got[name] = ([ln.replace(str(d), "<dir>") for ln in lines],
                         rel, text)
        assert got["port"] == got["ref"]

    def test_full_run_loads(self, tmp_path):
        from fleetflow_tpu_torch.cli.wizard import run_wizard
        from fleetflow_tpu_torch.core.loader import load_project
        target = run_wizard(project_root=str(tmp_path), default_name="p",
                            prompt_fn=scripted("demo", "2", "2", "y"),
                            print_fn=lambda s: None)
        assert target == tmp_path / ".fleetflow" / "fleet.kdl"
        flow = load_project(stage="local", start=str(tmp_path))
        assert flow.name == "demo"
        assert set(flow.services) == {"postgres", "redis", "app"}

    def test_existing_file_needs_force(self, tmp_path):
        from fleetflow_tpu_torch.cli.wizard import run_wizard
        (tmp_path / "fleet.kdl").write_text('project "old"\n')
        assert run_wizard(project_root=str(tmp_path), default_name="x",
                          prompt_fn=scripted("x", "3", "1", "y"),
                          print_fn=lambda s: None) is None
        assert run_wizard(project_root=str(tmp_path), default_name="x",
                          prompt_fn=scripted("x", "3", "1", "y"),
                          print_fn=lambda s: None, force=True) == \
            tmp_path / "fleet.kdl"

    @pytest.mark.parametrize("keys,default", [
        (["down", "down", "enter"], 0), (["up", "enter"], 0),
        (["down", "enter"], 2), (["q"], 0), (["esc"], 0), (["2"], 0)])
    def test_tty_picker_equals_the_reference(self, keys, default):
        import io
        import sys
        from fleetflow_tpu.cli.wizard import _pick_tty as ref_pick
        from fleetflow_tpu_torch.cli.wizard import _pick_tty
        got = []
        for fn in (ref_pick, _pick_tty):
            feed = iter(keys)
            buf = io.StringIO()
            real, sys.stdout = sys.stdout, buf
            try:
                sel = fn("t:", ["a", "b", "c"], default=default,
                         read_key=lambda: next(feed))
            finally:
                sys.stdout = real
            got.append((sel, buf.getvalue()))
        assert got[0] == got[1]

    def test_non_tty_init(self, tmp_path, capsys):
        rc, _, _ = fleet(PORT_ROOT, ["--project-root", str(tmp_path),
                                     "init", "--no-wizard"], capsys)
        assert rc == 0 and (tmp_path / ".fleetflow" / "fleet.kdl").exists()


class TestSelfUpdate:
    def test_version(self):
        import fleetflow_tpu
        import fleetflow_tpu_torch
        assert fleetflow_tpu_torch.__version__ == fleetflow_tpu.__version__

    @pytest.mark.parametrize("latest,current", [
        ("0.2.0", "0.1.0"), ("0.1.0", "0.1.0"), ("0.1.0", "0.2.0"),
        ("0.10.0", "0.9.9"), ("1.0.0", "0.99.99"), ("v0.2.1", "0.2.0"),
        ("0.2", "0.2.0")])
    def test_compare_equals_the_reference(self, latest, current):
        from fleetflow_tpu.cli.self_update import is_newer_version as ref
        from fleetflow_tpu_torch.cli.self_update import is_newer_version
        assert is_newer_version(latest, current) is ref(latest, current)

    @pytest.mark.parametrize("os_name,arch", [
        ("darwin", "arm64"), ("darwin", "x86_64"), ("linux", "x86_64"),
        ("linux", "aarch64"), ("win32", "x86_64"), ("linux", "riscv64")])
    def test_pick_asset_equals_the_reference(self, os_name, arch):
        from fleetflow_tpu.cli.self_update import pick_asset as ref
        from fleetflow_tpu_torch.cli.self_update import pick_asset
        assert pick_asset(os_name, arch) == ref(os_name, arch)

    @pytest.mark.parametrize("release", [
        {"tag_name": "v0.0.1"}, {"tag_name": "v9.9.9", "assets": []},
        {"tag_name": "v9.9.9", "assets": [
            {"name": "fleetflow-linux-amd64.tar.gz",
             "browser_download_url": "https://x/fleetflow-linux-amd64"
                                     ".tar.gz"}]}, {}])
    def test_self_update_equals_the_reference(self, release):
        from fleetflow_tpu.cli import self_update as ref
        from fleetflow_tpu_torch.cli import self_update as port
        got = []
        for mod in (ref, port):
            lines = []
            rc = mod.self_update(fetcher=lambda url: release,
                                 print_fn=lines.append, dry_run=True)
            got.append((rc, lines))
        assert got[0] == got[1]

    def test_cli_dry_run_without_network(self, monkeypatch, capsys):
        # the fetcher's urlopen refused here: no request leaves the host
        def refuse(*a, **kw):
            raise urllib.error.URLError("offline")
        monkeypatch.setattr(urllib.request, "urlopen", refuse)
        rc, out, _ = fleet(PORT_ROOT, ["self-update", "--dry-run"], capsys)
        assert rc == 1 and "could not reach" in out


# --------------------------------------------------------------------------
# placement explain / state over a fake client (test_cli_mcp.py)
# --------------------------------------------------------------------------

def _explain_payload(rank):
    node = {"node": "n1", "feasible": rank is not None,
            "eligible": True, "valid": True, "fits_capacity": True,
            "conflicts": {"ports": 0, "volumes": 0, "anti_affinity": 0},
            "strategy_term": 0.001, "preference": 0.0, "coloc_mates": 0,
            "score": 0.001, "utilization_after": [0.2, 0.1, 0.0]}
    return {"service": "api", "row": 1, "replica_of": "api",
            "demand": [1, 64, 1], "strategy": "spread_across_pool",
            "chosen": node, "chosen_rank": rank,
            "alternatives": [dict(node, node="n2", score=0.002)],
            "blocked_counts": {"ineligible": 0, "invalid": 1,
                               "capacity": 0, "conflicts": 0,
                               "feasible": 2, "total_nodes": 3}}


class FakeCp:
    def __init__(self, answers):
        self.answers = answers

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def request(self, channel, method, p=None, timeout=60.0):
        return self.answers[(channel, method)]


@pytest.mark.parametrize("argv,answers", [
    (["cp", "placement", "explain", "--stage", "shop/live", "--service",
      "api"], {("placement", "explain"): _explain_payload(1)}),
    (["cp", "placement", "explain", "--stage", "shop/live", "--service",
      "api"], {("placement", "explain"): _explain_payload(None)}),
    (["cp", "placement", "state"], {("placement", "reservations"): {
        "in_flight": [{"id": "r1", "stage": "shop/live", "churn": True,
                       "demand_by_node": {"n1": [1, 64, 1]}}],
        "committed": []}})], ids=["explain", "explain-infeasible", "state"])
def test_placement_verbs_equal_the_reference(argv, answers, monkeypatch,
                                             capsys):
    outs = []
    for root in (REF_ROOT, PORT_ROOT):
        monkeypatch.setattr(cli(root), "CpClient",
                            lambda endpoint=None: FakeCp(answers))
        outs.append(fleet(root, argv, capsys))
    assert outs[0] == outs[1] and outs[1][0] == 0


# --------------------------------------------------------------------------
# the client
# --------------------------------------------------------------------------

class TestCredentials:
    def test_store_roundtrip(self, tmp_path):
        from fleetflow_tpu_torch.cli.client import CredentialStore
        store = CredentialStore(path=str(tmp_path / "creds.json"))
        assert store.token_for("h:1") is None
        store.save_token("h:1", "tok123", email="a@b.c")
        assert store.token_for("h:1") == "tok123"
        assert store.forget("h:1") is True and store.token_for("h:1") is None
        assert store.forget("h:1") is False

    def test_across_packages(self, tmp_path):
        from fleetflow_tpu.cli.client import CredentialStore as Ref
        from fleetflow_tpu_torch.cli.client import CredentialStore as Port
        path = str(tmp_path / "creds.json")
        Port(path=path).save_token("h:1", "a", email="x@y")
        Ref(path=path).save_token("h:2", "b")
        assert Ref(path=path).token_for("h:1") == "a"
        assert Port(path=path).token_for("h:2") == "b"
        assert oct(os.stat(path).st_mode & 0o777) == "0o600"

    def test_login_with_secret_and_logout(self, tmp_path, monkeypatch,
                                          capsys):
        from fleetflow_tpu_torch.cp.auth import TokenAuth
        monkeypatch.setenv("HOME", str(tmp_path))
        rc, out, _ = fleet(PORT_ROOT, ["cp", "--cp", "h:9", "login",
                                       "--secret", "s3", "--email", "o@x"],
                           capsys)
        assert rc == 0 and out == "credentials saved for h:9\n"
        saved = json.loads(
            (tmp_path / ".config/fleetflow/credentials.json").read_text())
        assert TokenAuth("s3").verify(saved["h:9"]["token"]).email == "o@x"
        assert fleet(PORT_ROOT, ["cp", "--cp", "h:9", "logout"],
                     capsys)[1] == "logged out\n"


def _client_roundtrip(server_pkg, client_root, tmp_path):
    """`client_root`'s CpClient against a control plane of `server_pkg`
    on a socket: ping, a server registered and listed, a tenant made."""
    client = importlib.import_module(f"{client_root}.cli.client")

    async def go():
        handle = await start_cp(server_pkg)

        def use():
            c = client.CpClient(endpoint=f"{handle.host}:{handle.port}",
                                ca_path=str(tmp_path / "absent-ca.pem"))
            out = [c.request("health", "ping")["pong"]]
            c.request("server", "register", {"slug": "n1"})
            out.append([s["slug"] for s in
                        c.request("server", "list")["servers"]])
            out.append(c.request("tenant", "create",
                                 {"name": "acme"})["tenant"]["name"])
            c.close()
            return out
        out = await asyncio.get_running_loop().run_in_executor(None, use)
        await handle.stop()
        return out
    return run(go())


class TestSyncCpClient:
    @pytest.mark.parametrize("server,client", [
        (PORT, PORT_ROOT), (PORT_CARD, PORT_ROOT), (REF, PORT_ROOT),
        (PORT, REF_ROOT), (PORT_CARD, REF_ROOT)],
        ids=["port-port", "portcard-port", "ref-port", "port-ref",
             "portcard-ref"])
    def test_roundtrip_across_packages(self, server, client, tmp_path,
                                       monkeypatch):
        monkeypatch.delenv("FLEET_CP_CA", raising=False)
        assert _client_roundtrip(server, client, tmp_path) == \
            [True, ["n1"], "acme"]

    def test_stale_ca_diagnosis_and_override(self, tmp_path, monkeypatch):
        pytest.importorskip("cryptography")
        from fleetflow_tpu_torch.cli.client import CpClient
        from fleetflow_tpu_torch.cp.cert import ensure_mesh_ca
        from fleetflow_tpu_torch.cp.protocol import RpcError
        ensure_mesh_ca(str(tmp_path / "stale-ca"))
        ca_pem = tmp_path / "stale-ca" / "ca.pem"

        async def go():
            handle = await start_cp(PORT)
            loop = asyncio.get_running_loop()

            def pinned_fails():
                monkeypatch.delenv("FLEET_CP_CA", raising=False)
                c = CpClient(endpoint=f"{handle.host}:{handle.port}",
                             ca_path=str(ca_pem))
                with pytest.raises(RpcError, match="FLEET_CP_CA"):
                    c.request("health", "ping")

            def override_works():
                monkeypatch.setenv("FLEET_CP_CA", "")
                c = CpClient(endpoint=f"{handle.host}:{handle.port}",
                             ca_path=str(ca_pem))
                out = c.request("health", "ping")
                c.close()
                return out
            await loop.run_in_executor(None, pinned_fails)
            assert (await loop.run_in_executor(None, override_works))["pong"]
            await handle.stop()
        run(go())

    def test_cli_against_a_live_server(self, tmp_path, monkeypatch, capsys):
        """`fleet cp status` / `cp server list` / `cp placement state`
        through both packages' CLIs against one port server."""
        monkeypatch.delenv("FLEET_CP_CA", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))

        async def go():
            handle = await start_cp(PORT_CARD)
            handle.state.store.register_server("n1")
            ep = f"{handle.host}:{handle.port}"
            loop = asyncio.get_running_loop()
            outs = []
            for argv in (["cp", "--cp", ep, "status"],
                         ["cp", "--cp", ep, "server", "list"],
                         ["cp", "--cp", ep, "placement", "state"]):
                pair = []
                for root in (REF_ROOT, PORT_ROOT):
                    pair.append(await loop.run_in_executor(
                        None, lambda r=root, a=argv: fleet(r, a, capsys)))
                outs.append(pair)
            await handle.stop()
            return outs
        for ref, port in run(go()):
            assert port[0] == 0 and port[0] == ref[0]
            assert port[1] == ref[1]


class TestDeviceFlow:
    @pytest.fixture
    def mock_idp(self):
        from test_auth_idp import MockIdpHandler
        srv = HTTPServer(("127.0.0.1", 0), MockIdpHandler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        MockIdpHandler.deny = False
        yield f"http://127.0.0.1:{srv.server_port}", MockIdpHandler
        MockIdpHandler.deny = False
        srv.shutdown()
        t.join(timeout=5)

    def test_login_polls_until_grant(self, mock_idp):
        from fleetflow_tpu.cli.device_flow import device_login as ref_login
        from fleetflow_tpu_torch.cli.device_flow import device_login
        url, _ = mock_idp
        got = []
        for fn in (ref_login, device_login):
            shown = []
            tok = fn(url, "cli-1", out=shown.append, sleep=lambda s: None)
            got.append((tok, shown))
        assert got[0] == got[1] and got[1][0]["access_token"] == "tok-xyz"
        assert any("ABCD-EFGH" in s for s in got[1][1])

    def test_login_denied(self, mock_idp):
        from fleetflow_tpu_torch.cli.device_flow import (DeviceFlowError,
                                                         device_login)
        url, handler = mock_idp
        handler.deny = True
        with pytest.raises(DeviceFlowError, match="denied"):
            device_login(url, "cli-1", out=lambda s: None,
                         sleep=lambda s: None)

    def test_cli_login_via_idp(self, mock_idp, tmp_path, monkeypatch,
                               capsys):
        url, _ = mock_idp
        monkeypatch.setenv("HOME", str(tmp_path))
        rc, _, _ = fleet(PORT_ROOT, ["cp", "login", "--idp", url,
                                     "--client-id", "cli-1"], capsys)
        assert rc == 0
        saved = json.loads(
            (tmp_path / ".config/fleetflow/credentials.json").read_text())
        assert any(v.get("token") == "tok-xyz" for v in saved.values())


# --------------------------------------------------------------------------
# chip_smoke's [cli] phase, rehearsed on the CPU at a small size
# --------------------------------------------------------------------------

def test_chip_smoke_cli_phase_rehearsal(tmp_path, monkeypatch):
    """`chip_smoke.run_cli_phase` with the card scheduler's plain versions
    (``--device cpu``, ``solver-device "cpu"``) on a 120-service fleet of
    12 servers and a 3-fleet registry: every step runs and passes its
    checks (the launch checks stubbed: the plain versions launch
    nothing)."""
    import torch

    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.solver.repair import verify
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))
    monkeypatch.setattr(chip_smoke, "cp_expect_launches",
                        lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "BY_SIZE", {})
    out = chip_smoke.run_cli_phase(
        torch, np, _ext, REGISTRY, verify, "cpu", "CARD", device="cpu",
        fleet=dict(fleet="t0", n_services=120, seed=100, n_nodes_hint=12,
                   port_base=10000),
        servers=dict(n=12, seed=7), shape=None,
        registry=dict(services=40, nodes=12, fleets=3), registry_shape=None,
        root=str(tmp_path / "cli"))
    assert out["steps"] == 18 and not out["over_budget"]
    assert not (tmp_path / "cli" / "fleetflowd.pid").exists()
    # the children wrote their counts at exit: the solve, the daemon's
    # start and stop processes, the daemon itself and the MCP server
    launch_dirs = sorted(p.name for p in (tmp_path / "cli" / "launches")
                         .iterdir())
    assert launch_dirs == ["daemon", "mcp", "solve"]
