"""The port's flow parser (fleetflow_tpu_torch.core.parser) against the
reference's on the reference's parser corpus.

Every KDL text of the reference's parser, lowering, front-end, lint and
explain tests goes through both packages' ``parse_kdl_string``: the Flows
must serialize (each package's ``serialize.flow_to_dict``) to the same
dict, once with the native KDL parser and once with FLEET_KDL_NATIVE=0,
or raise the same error with the same message. The model's methods that
the parser's tests read (image names, resolved stage services, wait
backoff) agree, the dict codecs round-trip across the packages, and the
include expansion reads the same files to the same text.
"""

import pytest

from fleetflow_tpu.core import errors as ref_errors
from fleetflow_tpu.core import model as ref_model
from fleetflow_tpu.core import parser as ref_parser
from fleetflow_tpu.core import serialize as ref_ser
from fleetflow_tpu_torch.core import errors as port_errors
from fleetflow_tpu_torch.core import model as port_model
from fleetflow_tpu_torch.core import parser as port_parser
from fleetflow_tpu_torch.core import serialize as port_ser
from torch_frontend_cases import harvest, run

CORPUS = harvest("test_parser.py", "test_lower.py", "test_frontend.py",
                 "test_lint.py", "test_explain.py", "test_kdl.py")


def parse_both(text, **kw):
    ref = run(ref_parser.parse_kdl_string, text, cache=False, **kw)
    port = run(port_parser.parse_kdl_string, text, cache=False, **kw)
    return ref, port


def as_dict(result, ser):
    return result if result[0] == "error" else ("ok",
                                                ser.flow_to_dict(result[1]))


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_parse_parity(text, native, monkeypatch):
    monkeypatch.setenv("FLEET_KDL_NATIVE", native)
    ref, port = parse_both(text)
    assert as_dict(port, port_ser) == as_dict(ref, ref_ser)


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_model_methods_parity(text):
    ref, port = parse_both(text)
    if ref[0] == "error":
        return
    rf, pf = ref[1], port[1]
    assert [s.image_name() for s in pf.services.values()] == \
        [s.image_name() for s in rf.services.values()]
    for name in rf.stages:
        want = run(lambda: [s.name for s in
                            rf.stages[name].resolved_services(rf)])
        got = run(lambda: [s.name for s in
                           pf.stages[name].resolved_services(pf)])
        assert got == want


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_dict_codecs_cross_packages(text):
    """The wire dict of either package decodes in the other to the same
    dict (a Flow can cross between them)."""
    ref, port = parse_both(text)
    if ref[0] == "error":
        return
    d = ref_ser.flow_to_dict(ref[1])
    assert port_ser.flow_to_dict(port_ser.flow_from_dict(d)) == d
    assert ref_ser.flow_to_dict(ref_ser.flow_from_dict(
        port_ser.flow_to_dict(port[1]))) == d


def test_spans_parity():
    """want_spans: the model objects carry the same source locations."""
    text = 'project "t"\nservice "web" {\n    image "nginx"\n}\n' \
           'stage "live" { service "web" }\n'
    ref = ref_parser.parse_kdl_string(text, want_spans=True, source="f.kdl")
    port = port_parser.parse_kdl_string(text, want_spans=True,
                                        source="f.kdl")
    assert port.services["web"].loc.label() == \
        ref.services["web"].loc.label() == "f.kdl:2:1"
    assert port.stages["live"].loc.label() == ref.stages["live"].loc.label()


def test_wait_backoff_parity():
    for attempt in (0, 1, 4, 5, 100):
        assert port_model.WaitConfig().delay_for_attempt(attempt) == \
            ref_model.WaitConfig().delay_for_attempt(attempt)
    assert port_model.ResourceSpec.axes() == ref_model.ResourceSpec.axes()
    assert port_model.ResourceSpec.axes() is port_model.RESOURCE_AXES


def test_solver_types_are_the_model_types():
    """The solver raises and reads the model's own classes."""
    from fleetflow_tpu_torch.core import PlacementStrategy, SolverError
    from fleetflow_tpu_torch.lower import tensors
    from fleetflow_tpu_torch.solver import sharded
    assert tensors.PlacementStrategy is PlacementStrategy \
        is port_model.PlacementStrategy
    assert sharded.SolverError is tensors.SolverError is SolverError \
        is port_errors.SolverError
    assert [e.value for e in PlacementStrategy] == \
        [e.value for e in ref_model.PlacementStrategy]
    for name in ref_errors.__all__:
        assert getattr(port_errors, name).__mro__[1].__name__ == \
            getattr(ref_errors, name).__mro__[1].__name__


def _write(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


@pytest.mark.parametrize("files,main", [
    ({"main.kdl": 'project "p"\ninclude "svc.kdl"\n',
      "svc.kdl": 'service "db" { image "postgres" }\n'}, "main.kdl"),
    ({"main.kdl": 'include "services/*.kdl"\nproject "g"\n',
      "services/a.kdl": 'service "a" { }\n',
      "services/b.kdl": 'service "b" { }\ninclude "../more/*.kdl"\n',
      "more/c.kdl": 'service "c" { image "x" }\n'}, "main.kdl"),
    ({"a.kdl": 'include "b.kdl"\n', "b.kdl": 'include "a.kdl"\n'},
     "a.kdl"),
    ({"a.kdl": 'include "missing.kdl"\n'}, "a.kdl"),
    ({"a.kdl": 'include "none/*.kdl"\nservice "x" { }\n'}, "a.kdl"),
], ids=["include", "glob", "cycle", "missing", "empty-glob"])
def test_include_expansion_parity(tmp_path, files, main):
    _write(tmp_path, files)
    path = str(tmp_path / main)
    ref_segs, port_segs = [], []
    ref = run(ref_parser.read_kdl_with_includes, path, segments=ref_segs)
    port = run(port_parser.read_kdl_with_includes, path,
               segments=port_segs)
    assert port == ref and port_segs == ref_segs
    if ref[0] == "ok":
        assert as_dict(run(port_parser.parse_kdl_file, path), port_ser) == \
            as_dict(run(ref_parser.parse_kdl_file, path), ref_ser)
    else:
        with pytest.raises(port_errors.FlowError):
            port_parser.read_kdl_with_includes(path)


def test_fragment_merge_parity():
    """Fragments merged onto a flow, as the loader merges per-file parses:
    service redefinition merges and stages accumulate alike."""
    texts = ['project "m"\nservice "db" { image "postgres"; version "15" }',
             'service "db" { version "16"; ports { port 5432 5432 } }\n'
             'stage "live" { service "db" }',
             'stage "live" { service "cache" }\nservice "cache" { }']
    ref_flow, port_flow = ref_model.Flow(), port_model.Flow()
    for t in texts:
        ref_parser.merge_flow_fragment(
            ref_flow, ref_parser.parse_kdl_string(t, cache=False))
        port_parser.merge_flow_fragment(
            port_flow, port_parser.parse_kdl_string(t, cache=False))
    assert port_ser.flow_to_dict(port_flow) == ref_ser.flow_to_dict(ref_flow)
    assert port_ser.flow_to_dict(port_flow)["services"]["db"]["version"] \
        == "16"
