"""The port's lowering (fleetflow_tpu_torch.lower.tensors.lower_stage) and
fleet generator against the reference's: ProblemTensors bit-identical in
every field (tolerance 0).

The same Flow text is parsed by each package and lowered by each, for
every stage of every KDL text of the reference's lowering, parser,
front-end, lint and explain tests, every stage of the repo's examples
(also ``local=True``), and the generated fleets at 240x24, 2000x200 and
the full 10,000 x 1,000 one fleet of the reference bench's pipeline. A
stage that fails to lower fails with the same error in both.
"""

import dataclasses
import logging

import pytest

from fleetflow_tpu.core import parser as ref_parser
from fleetflow_tpu.lower import fleetgen as ref_gen
from fleetflow_tpu.lower import tensors as ref_tensors
from fleetflow_tpu_torch.core import parser as port_parser
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.lower import fleetgen as port_gen
from fleetflow_tpu_torch.lower import tensors as port_tensors
from test_torch_loader import example_roots
from torch_frontend_cases import harvest, run, tensor_diff

CORPUS = harvest("test_lower.py", "test_parser.py", "test_frontend.py",
                 "test_lint.py", "test_explain.py")


def lower_both(ref_flow, port_flow, stage, **kw):
    ref = run(ref_tensors.lower_stage, ref_flow, stage, **kw)
    port = run(port_tensors.lower_stage, port_flow, stage, **kw)
    assert port[0] == ref[0], (ref, port)
    if ref[0] == "error":
        assert port == ref
    else:
        assert tensor_diff(ref[1], port[1]) == []
    return ref, port


def _stages(text):
    """Both packages' Flows of `text` and its stages. A text that declares
    services is lowered also through one more stage that lists them all,
    so every per-service construct of the corpus is lowered."""
    ref = run(ref_parser.parse_kdl_string, text, cache=False)
    if ref[0] == "error":
        return None, None, []
    if ref[1].services:
        text += "\nstage \"all-services\" {\n" + "".join(
            f'    service "{name}"\n' for name in ref[1].services) + "}\n"
        ref = run(ref_parser.parse_kdl_string, text, cache=False)
        if ref[0] == "error":
            return None, None, []
    port = port_parser.parse_kdl_string(text, cache=False)
    return ref[1], port, list(ref[1].stages)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_corpus_lowering_parity(text, local):
    ref_flow, port_flow, stages = _stages(text)
    for stage in stages + ["no-such-stage"] * bool(stages):
        lower_both(ref_flow, port_flow, stage, local=local)


def test_examples_lowering_parity(tmp_path):
    from fleetflow_tpu import core as ref_core
    from fleetflow_tpu_torch import core as port_core
    n = 0
    for _ex, root, stages in example_roots(tmp_path):
        for stage in stages:
            ref_flow = ref_core.load_project_from_root_with_stage(
                root, stage, environ={})
            port_flow = port_core.load_project_from_root_with_stage(
                root, stage, environ={})
            for local in (False, True):
                ref, _ = lower_both(ref_flow, port_flow, stage, local=local)
                assert ref[0] == "ok"
                n += 1
    assert n >= 10


def fleet_pair(S, N, seed=100, port_base=10_000):
    kw = dict(seed=seed, n_nodes_hint=N, port_base=port_base)
    text = ref_gen.generate_fleet_kdl("t0", S, **kw)
    assert port_gen.generate_fleet_kdl("t0", S, **kw) == text
    servers = ref_gen.generate_servers_kdl(N, seed=7)
    assert port_gen.generate_servers_kdl(N, seed=7) == servers
    return text, servers


@pytest.mark.parametrize("S,N", [(240, 24), (2000, 200)])
@pytest.mark.parametrize("native", ["1", "0"])
def test_fleetgen_lowering_parity(S, N, native, monkeypatch):
    monkeypatch.setenv("FLEET_KDL_NATIVE", native)
    text, servers = fleet_pair(S, N)
    for pkg_parser, pkg_tensors in ((ref_parser, ref_tensors),
                                    (port_parser, port_tensors)):
        flow = pkg_parser.parse_kdl_string(text, cache=False)
        pool = pkg_parser.parse_kdl_string(servers, cache=False)
        if pkg_parser is ref_parser:
            ref_pt = pkg_tensors.lower_stage(
                flow, "prod", nodes=list(pool.servers.values()))
        else:
            port_pt = pkg_tensors.lower_stage(
                flow, "prod", nodes=list(pool.servers.values()))
    assert tensor_diff(ref_pt, port_pt) == []
    assert port_pt.N == N and port_pt.S > S       # replicas expanded
    assert (port_pt.coloc_ids >= 0).any() and (port_pt.port_ids >= 0).any()


def test_full_width_fleet_parity():
    """The reference bench pipeline's one fleet at full width: 10,602 rows
    x 1,000 nodes, bit-identical in every field."""
    text, servers = fleet_pair(10_000, 1_000)
    ref_flow = ref_parser.parse_kdl_string(text, cache=False)
    port_flow = port_parser.parse_kdl_string(text, cache=False)
    ref_nodes = list(ref_parser.parse_kdl_string(
        servers, cache=False).servers.values())
    port_nodes = list(port_parser.parse_kdl_string(
        servers, cache=False).servers.values())
    ref_pt = ref_tensors.lower_stage(ref_flow, "prod", nodes=ref_nodes)
    port_pt = port_tensors.lower_stage(port_flow, "prod", nodes=port_nodes)
    assert (port_pt.S, port_pt.N) == (10_602, 1_000)
    assert tensor_diff(ref_pt, port_pt) == []
    assert int((port_pt.port_ids >= 0).any(1).sum()) == 1957
    assert int(port_pt.dep_depth.max()) == 4
    assert port_pt.preferred is None


@pytest.mark.parametrize("S,N,seed", [(100, 10, 0), (600, 40, 3)])
def test_synthetic_problem_still_equal(S, N, seed):
    ref = ref_tensors.synthetic_problem(S, N, seed=seed, n_tenants=3)
    port = port_tensors.synthetic_problem(S, N, seed=seed, n_tenants=3)
    assert tensor_diff(ref, port) == []


def test_explicit_nodes_and_local_node():
    text = ('project "p"\nservice "a" { replicas 2; ports { port 80 80 } }\n'
            'service "b" { depends_on "a" }\nstage "s" { service "a"; '
            'service "b" }')
    ref_flow, port_flow, _ = _stages(text)
    assert port_tensors.LOCAL_NODE_NAME == ref_tensors.LOCAL_NODE_NAME
    ref_local = ref_tensors.local_node()
    port_local = port_tensors.local_node()
    assert dataclasses.asdict(port_local) == dataclasses.asdict(ref_local)
    ref, port = lower_both(ref_flow, port_flow, "s")
    assert port[1].node_names == ["local"]
    nodes_ref = [ref_tensors.local_node(f"n{i}") for i in range(3)]
    nodes_port = [port_tensors.local_node(f"n{i}") for i in range(3)]
    r = ref_tensors.lower_stage(ref_flow, "s", nodes=nodes_ref)
    p = port_tensors.lower_stage(port_flow, "s", nodes=nodes_port)
    assert tensor_diff(r, p) == [] and p.N == 3


def test_policy_helpers_parity():
    text = ('project "p"\nserver "a" { labels { tier "web"; zone "z1" } }\n'
            'server "b" { labels { tier "db" } }\nserver "c" { }\n'
            'service "x" { }\nstage "s" { service "x"\n placement {\n'
            '  tier "web"\n  required-labels { zone "z1" }\n'
            '  preferred-labels { zone "z1"; rack "r" }\n }\n}')
    ref_flow, port_flow, _ = _stages(text)
    ref_pol = ref_flow.stages["s"].placement
    port_pol = port_flow.stages["s"].placement
    for name in ("a", "b", "c"):
        assert port_tensors._server_matches(
            port_pol, port_flow.servers[name]) == \
            ref_tensors._server_matches(ref_pol, ref_flow.servers[name])
        assert port_tensors._preference_row(
            port_pol, port_flow.servers[name]) == \
            ref_tensors._preference_row(ref_pol, ref_flow.servers[name])
    assert port_tensors._server_matches(None, port_flow.servers["c"])


def test_unknown_colocate_target_warns_through_port_logger(caplog):
    text = ('project "p"\nservice "a" { colocate_with "ghost" }\n'
            'stage "s" { service "a" }')
    port_flow = port_parser.parse_kdl_string(text, cache=False)
    with caplog.at_level(logging.WARNING, logger="fleetflow.lower"):
        pt = port_tensors.lower_stage(port_flow, "s")
    assert any("ghost" in r.getMessage() and r.name == "fleetflow.lower"
               for r in caplog.records)
    ref_flow = ref_parser.parse_kdl_string(text, cache=False)
    assert tensor_diff(ref_tensors.lower_stage(ref_flow, "s"), pt) == []


def test_lowering_errors_are_solver_errors():
    for text, match in (
            ('service "a" { depends_on "b" }\nstage "s" { service "a" }',
             "unknown service"),
            ('service "a" { depends_on "b" }\nservice "b" { depends_on "a" '
             '}\nstage "s" { service "a"; service "b" }', "cycle"),
            ('service "site" { type "static" }\nstage "s" { service '
             '"site" }', "static-only"),
            ('service "a" { resources { cpu 2 } }\nstage "s" { service "a"'
             '\n placement { quota { cpu 1 } } }', "quota"),
            ('service "a" { }\nstage "s" { service "a"; servers "nope" }',
             "unknown servers")):
        flow = port_parser.parse_kdl_string(text, cache=False)
        with pytest.raises(SolverError, match=match):
            port_tensors.lower_stage(flow, "s")
