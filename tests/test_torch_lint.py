"""The port's lint (fleetflow_tpu_torch.lint) against the reference's
(fleetflow_tpu.lint), on the CPU.

- every fixture of tests/lint_fixtures/ gives identical diagnostics in
  both packages: code, severity, span, message, rule, stage and hint (and
  each fixture still fires exactly as its `// expect:` header stamps);
- the shipped examples lint clean in both;
- `deploy_blockers` equal, for the control plane (remote) and for local
  execution, over the fixtures' flows and the reference's programmatic
  cases;
- the SARIF documents equal;
- the rule catalog equal: codes, slugs, severities, scopes, structural
  flags;
- the reference's span, rule-engine and diagnostics cases on both.

- the reference's CLI cases (TestCliLint) through both packages' ``fleet
  lint``/``fleet validate``: the same exit code, stdout and stderr (the
  project's path normalised).
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import shutil
from types import SimpleNamespace

import pytest

FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FIXTURE_PATHS = sorted(glob.glob(os.path.join(FIXTURES, "*.kdl")))
# the fixtures that parse to a flow (FF000's is a parse error)
FLOW_PATHS = [p for p in FIXTURE_PATHS
              if not os.path.basename(p).startswith("ff000")]

_MODS = dict(lint="lint", sarif="lint.sarif", model="core.model",
             parser="core.parser", errors="core.errors")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)


def _expectations(path: str) -> list[tuple[str, str, int, int]]:
    out = []
    for line in open(path, encoding="utf-8").read().splitlines():
        if line.startswith("// expect: "):
            code, sev, span = line[len("// expect: "):].split()
            ln, col = span.split(":")
            out.append((code, sev, int(ln), int(col)))
    return out


def _fixture_env(path: str, monkeypatch) -> None:
    if "ff009" in path and shutil.which("op"):
        pytest.skip("op CLI installed; FF009 cannot fire here")
    if "ff016" in path:
        # the fixture header's tiny budget stands in for a pod-scale stage
        monkeypatch.setenv("FLEET_LINT_DEVICE_BUDGET_MB", "0.001")


def _diags(diags) -> list[dict]:
    return [d.to_dict() for d in diags]


def _lint_fixture(P, path: str):
    return P.lint.lint_text(open(path, encoding="utf-8").read(),
                            os.path.basename(path))


# --------------------------------------------------------------------------
# the fixtures: one broken world per rule
# --------------------------------------------------------------------------

class TestFixtures:
    @pytest.mark.parametrize("path", FIXTURE_PATHS,
                             ids=lambda p: os.path.basename(p)[:-4])
    def test_identical_diagnostics(self, path, monkeypatch):
        _fixture_env(path, monkeypatch)
        ref, port = (_lint_fixture(P, path) for P in BOTH)
        assert _diags(port.diagnostics) == _diags(ref.diagnostics)
        assert [d.format() for d in port.diagnostics] == \
            [d.format() for d in ref.diagnostics]
        got = [(d.code, d.severity.value, d.line, d.col)
               for d in port.diagnostics]
        assert sorted(got) == sorted(_expectations(path))
        assert port.ok() == ref.ok() and port.ok(True) == ref.ok(True)
        assert [len(x) for x in (port.errors, port.warnings, port.infos)] == \
            [len(x) for x in (ref.errors, ref.warnings, ref.infos)]

    @pytest.mark.parametrize("path", FLOW_PATHS,
                             ids=lambda p: os.path.basename(p)[:-4])
    @pytest.mark.parametrize("local", [False, True], ids=["remote", "local"])
    def test_identical_deploy_blockers(self, path, local, monkeypatch):
        _fixture_env(path, monkeypatch)
        ref_flow = _lint_fixture(REF, path).flow
        port_flow = _lint_fixture(PORT, path).flow
        for stage in sorted(ref_flow.stages):
            ref = REF.lint.deploy_blockers(ref_flow, stage, local=local)
            port = PORT.lint.deploy_blockers(port_flow, stage, local=local)
            assert _diags(port) == _diags(ref), stage
            assert all(d.severity is PORT.lint.Severity.ERROR for d in port)

    @pytest.mark.parametrize("path", FIXTURE_PATHS,
                             ids=lambda p: os.path.basename(p)[:-4])
    def test_identical_sarif(self, path, monkeypatch):
        _fixture_env(path, monkeypatch)
        docs = [json.dumps(P.sarif.to_sarif(_lint_fixture(P, path)
                                            .diagnostics, version="1"),
                           sort_keys=True) for P in BOTH]
        assert docs[1] == docs[0]

    def test_rule_catalog_equal(self):
        def catalog(P):
            return [(r.code, r.slug, r.severity.value, r.scope, r.structural,
                     r.doc) for r in P.lint.RULES]
        assert catalog(PORT) == catalog(REF)
        assert (PORT.lint.LOAD_ERROR.code, PORT.lint.LOAD_ERROR.slug) == \
            (REF.lint.LOAD_ERROR.code, REF.lint.LOAD_ERROR.slug)

    def test_every_rule_has_a_fixture(self):
        have = {os.path.basename(p).split("_")[0].upper()
                for p in FIXTURE_PATHS}
        want = {r.code for r in PORT.lint.RULES} | {"FF000"}
        assert want <= have, sorted(want - have)

    def test_exports_equal(self):
        assert sorted(PORT.lint.__all__) == sorted(REF.lint.__all__)


# --------------------------------------------------------------------------
# the shipped examples lint clean in both
# --------------------------------------------------------------------------

class TestExamplesClean:
    @pytest.mark.parametrize("name,stage", [("hello-world", "local"),
                                            ("production", "local")])
    def test_example_lints_clean_alike(self, name, stage):
        ref, port = (P.lint.lint_project(os.path.join(EXAMPLES, name), stage)
                     for P in BOTH)
        assert not [d.format() for d in port.errors]
        assert _diags(port.diagnostics) == _diags(ref.diagnostics)
        assert port.sourcemap.segments == ref.sourcemap.segments


# --------------------------------------------------------------------------
# spans, the rule engine, the gate and the diagnostics, on both
# --------------------------------------------------------------------------

SPAN_TEXT = '''project "t"
service "web" {
    image "nginx"
    ports { port 8080 80 }
    depends_on "db"
}
service "db" { image "postgres" }
server "n1" { capacity { cpu 4; memory 819; disk 1024 } }
stage "live" { service "web"; service "db"; servers "n1" }
'''


def _flow_with_cycle(P):
    m = P.model
    flow = m.Flow(name="t")
    flow.services["a"] = m.Service(name="a", image="x", depends_on=["b"])
    flow.services["b"] = m.Service(name="b", image="x", depends_on=["a"])
    flow.stages["live"] = m.Stage(name="live", services=["a", "b"])
    return flow


def _flow_two_ports(P):
    m = P.model
    flow = m.Flow(name="t")
    for n in ("a", "b"):
        flow.services[n] = m.Service(name=n, image="x",
                                     ports=[m.Port(host=80, container=80)])
    flow.stages["live"] = m.Stage(name="live", services=["a", "b"])
    return flow


def _flow_replicas(P):
    m = P.model
    flow = m.Flow(name="t")
    flow.services["web"] = m.Service(name="web", image="x", replicas=3,
                                     ports=[m.Port(host=8080, container=80)])
    flow.stages["live"] = m.Stage(name="live", services=["web"])
    return flow


def _flow_override(P):
    m = P.model
    flow = m.Flow(name="t")
    flow.services["web"] = m.Service(name="web", image="x",
                                     ports=[m.Port(host=8080, container=80)])
    ov = m.Service(name="web", replicas=4, _replicas_set=True)
    flow.stages["live"] = m.Stage(name="live", services=["web"],
                                  service_overrides={"web": ov})
    return flow


def _flow_cp_only(P):
    m = P.model
    flow = m.Flow(name="t")
    flow.services["a"] = m.Service(name="a", image="x")
    flow.stages["live"] = m.Stage(name="live", services=["a"],
                                  servers=["cp-only-node"])
    return flow


def _flow_scoped(P):
    flow = _flow_with_cycle(P)
    flow.stages["ok"] = P.model.Stage(name="ok", services=["a"])
    return flow


FLOWS = {"cycle": _flow_with_cycle, "two_ports": _flow_two_ports,
         "replicas": _flow_replicas, "override": _flow_override,
         "cp_only": _flow_cp_only, "scoped": _flow_scoped}


class TestRuleEngine:
    @pytest.mark.parametrize("flow_of", sorted(FLOWS))
    @pytest.mark.parametrize("prelint", [False, True])
    def test_lint_flow_equal(self, flow_of, prelint):
        ref, port = (P.lint.lint_flow(FLOWS[flow_of](P), prelint=prelint)
                     for P in BOTH)
        assert _diags(port) == _diags(ref)

    @pytest.mark.parametrize("flow_of", sorted(FLOWS))
    @pytest.mark.parametrize("local", [False, True], ids=["remote", "local"])
    def test_deploy_blockers_equal(self, flow_of, local):
        out = []
        for P in BOTH:
            flow = FLOWS[flow_of](P)
            out.append({st: _diags(P.lint.deploy_blockers(flow, st,
                                                          local=local))
                        for st in sorted(flow.stages)})
        assert out[1] == out[0]

    def test_reference_expectations_on_the_port(self):
        P = PORT
        diags = P.lint.lint_flow(_flow_with_cycle(P), prelint=False)
        assert [d.code for d in diags] == ["FF001"]
        assert diags[0].line == 0 and diags[0].file is None
        only_ok = P.lint.lint_flow(_flow_scoped(P), stage_name="ok",
                                   prelint=False)
        assert [d.code for d in only_ok] == ["FF002"]
        assert not any(d.code == "FF013" for d in P.lint.lint_flow(
            _flow_with_cycle(P), prelint=True))
        ff6 = [d for d in P.lint.lint_flow(_flow_override(P), prelint=False)
               if d.code == "FF006"]
        assert ff6 and "4 service row(s)" in ff6[0].message
        assert not P.lint.deploy_blockers(_flow_two_ports(P), "live")
        assert [d.code for d in P.lint.deploy_blockers(
            _flow_two_ports(P), "live", local=True)] == ["FF006"]
        assert P.lint.deploy_blockers(_flow_cp_only(P), "live") == []

    def test_spans_equal(self):
        flows = [P.parser.parse_kdl_string(SPAN_TEXT, want_spans=True)
                 for P in BOTH]
        for ref, port in [flows]:
            web_r, web_p = ref.services["web"], port.services["web"]
            assert (web_p.loc.line, web_p.loc.col) == \
                (web_r.loc.line, web_r.loc.col) == (2, 1)
            assert (web_p.dep_locs["db"].line, web_p.dep_locs["db"].col) == \
                (5, 5)
            st = port.stages["live"]
            assert (st.server_locs["n1"].line, st.server_locs["n1"].col) == \
                (9, 45)
        ref, port = (P.lint.lint_text(SPAN_TEXT, "span.kdl") for P in BOTH)
        assert _diags(port.diagnostics) == _diags(ref.diagnostics)

    def test_include_expansion_spans_equal(self, tmp_path):
        (tmp_path / "extra").mkdir()
        (tmp_path / "extra" / "cache.kdl").write_text(
            'service "cache" {\n    image "redis"\n}\n')
        main = tmp_path / "fleet.kdl"
        main.write_text('project "inc"\n'
                        'include "extra/*.kdl"\n'
                        'service "web" {\n'
                        '    image "nginx"\n'
                        '    depends_on "ghost"\n'
                        '}\n'
                        'stage "local" { service "web"; service "cache" }\n')
        out = []
        for P in BOTH:
            segs: list = []
            text = P.parser.read_kdl_with_includes(str(main), segments=segs)
            flow = P.parser.parse_kdl_string(text, want_spans=True)
            sm = P.lint.SourceMap(segments=segs)
            out.append(_diags(P.lint.lint_flow(flow, sm, prelint=False)))
        assert out[1] == out[0]
        ff2 = [d for d in out[1] if d["code"] == "FF002"]
        assert len(ff2) == 1 and ff2[0]["line"] == 5

    def test_multi_file_project_equal(self, project):
        root, write = project
        write("services/broken.kdl", '''service "looper" {
    image "x"
    depends_on "looper2"
}
service "looper2" {
    image "x"
    depends_on "looper"
}
stage "cyc" { service "looper"; service "looper2" }
''')
        ref, port = (P.lint.lint_project(str(root), "local") for P in BOTH)
        assert _diags(port.diagnostics) == _diags(ref.diagnostics)
        cyc = [d for d in port.diagnostics if d.code == "FF001"]
        assert len(cyc) == 1 and cyc[0].line == 3
        assert cyc[0].file.endswith("services/broken.kdl")

    @pytest.mark.parametrize("text", [
        'service "v" {\n    image "x"\n    volume "./data" "/data" '
        'read-only="flase"\n}',
        'service "v" { image "x" ',
    ], ids=["strict_bool", "unterminated"])
    def test_load_errors_equal(self, text):
        ref, port = (P.lint.lint_text(text, "bad.kdl") for P in BOTH)
        assert _diags(port.diagnostics) == _diags(ref.diagnostics)
        assert [d.code for d in port.diagnostics] == ["FF000"]

    def test_sourcemap_resolves_alike(self):
        for P in BOTH:
            sm = P.lint.SourceMap.from_parts(["a.kdl", "b.kdl"],
                                             ["l1\nl2\nl3", "m1\nm2"])
            assert [sm.resolve(i) for i in range(0, 7)] == [
                (None, 0), ("a.kdl", 1), ("a.kdl", 2), ("a.kdl", 3),
                ("b.kdl", 1), ("b.kdl", 2), ("b.kdl", 3)]


class TestDiagnostics:
    @pytest.mark.parametrize("fields", [
        dict(code="FF001", severity="error", message="boom", file="f.kdl",
             line=3, col=7, stage="live", hint="fix it"),
        dict(code="FF006", severity="warning", message="m", file="f",
             line=1, col=2, rule="slug", stage="s"),
        dict(code="FF009", severity="warning", message="m"),
        dict(code="FF014", severity="info", message="m", function="fn"),
    ], ids=["hint", "to_dict", "spanless", "info"])
    def test_format_and_dict_equal(self, fields):
        out = []
        for P in BOTH:
            kw = dict(fields, severity=P.lint.Severity(fields["severity"]))
            d = P.lint.Diagnostic(**kw)
            out.append((d.format(), d.to_dict(), d.span()))
            assert P.lint.severity_counts([d]) == (
                int(fields["severity"] == "error"),
                int(fields["severity"] == "warning"))
        assert out[1] == out[0]


# --------------------------------------------------------------------------
# the CLI (test_lint.py's TestCliLint), through both packages' `fleet`
# --------------------------------------------------------------------------

_BAD = ('service "x" { image "i"; depends_on "nope" }\n'
        'stage "local" { service "x" }\n')
_WARN = ('service "imageless" { env { A "1" } }\n'
         'stage "local" { service "imageless" }\n')


def _fleet_both(root, argv, capsys):
    """(rc, stdout, stderr) of `fleet --project-root root argv` in each
    package, the project's path normalised."""
    out = []
    for pkg in ("fleetflow_tpu", "fleetflow_tpu_torch"):
        main = importlib.import_module(f"{pkg}.cli.main").main
        capsys.readouterr()
        rc = main(["--project-root", str(root), *argv])
        cap = capsys.readouterr()
        out.append((rc, cap.out.replace(str(root), "<dir>"),
                    cap.err.replace(str(root), "<dir>")))
    assert out[1] == out[0]
    return out[1]


class TestCliLint:
    def test_clean_project_exits_zero(self, project, capsys):
        rc, out, _ = _fleet_both(project[0], ["lint"], capsys)
        assert rc == 0 and "config valid" in out

    def test_broken_project_exits_one_with_spans(self, project, capsys):
        root, write = project
        write("services/bad.kdl", _BAD)
        rc, _, err = _fleet_both(root, ["lint"], capsys)
        assert rc == 1 and "FF002" in err and "services/bad.kdl:1" in err

    def test_json_format(self, project, capsys):
        root, write = project
        write("services/bad.kdl", _BAD)
        rc, out, _ = _fleet_both(root, ["lint", "--format", "json"], capsys)
        doc = json.loads(out)
        assert rc == 1 and doc["ok"] is False and doc["errors"] == 1
        d = doc["diagnostics"][0]
        assert d["code"] == "FF002" and d["severity"] == "error"
        assert d["file"].endswith("services/bad.kdl") and d["line"] == 1

    def test_sarif_format(self, project, capsys):
        root, write = project
        write("services/bad.kdl", _BAD)
        rc, out, _ = _fleet_both(root, ["lint", "--format", "sarif"],
                                 capsys)
        assert rc == 1 and json.loads(out)["version"] == "2.1.0"

    def test_strict_promotes_warnings(self, project, capsys):
        root, write = project
        write("services/warn.kdl", _WARN)
        assert _fleet_both(root, ["lint"], capsys)[0] == 0
        assert _fleet_both(root, ["lint", "--strict"], capsys)[0] == 1

    def test_validate_delegates_to_lint(self, project, capsys):
        root, write = project
        write("services/bad.kdl", _BAD)
        rc, _, err = _fleet_both(root, ["validate"], capsys)
        assert rc == 1 and "FF002" in err

    @pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
    def test_missing_config(self, tmp_path, capsys, fmt):
        rc, out, _ = _fleet_both(tmp_path, ["lint", "--format", fmt], capsys)
        assert rc == 2
        if fmt == "json":
            doc = json.loads(out)
            assert doc["ok"] is False and "reason" in doc
