"""The port's native KDL parser (csrc/host/kdl.cpp through
fleetflow_tpu_torch.native.kdl) against its Python parser and the
reference's, on the reference's native-parity corpus.

Both assemblies of the native tree are held to the Python parsers: the
CPython extension (csrc/host/kdlpy.cpp) and the ctypes-array loop
(FLEET_KDL_ASSEMBLY=ctypes). Valid documents give the same trees; invalid
ones are never accepted natively and raise the canonical KdlError through
``parse_document``; documents outside the native subset (int64 overflow,
unicode classification risk) fall back to Python. The semantic fallbacks
are kept; the build fallback is not: a library that cannot be built
raises, with the compiler's output.
"""

import dataclasses
import os
import random
import sysconfig

import pytest

from fleetflow_tpu.core import kdl as ref_kdl
from fleetflow_tpu_torch import _ext
from fleetflow_tpu_torch.core import kdl as port_kdl
from fleetflow_tpu_torch.core.kdl import KdlError, parse_document
from fleetflow_tpu_torch.native import kdl as nk
from test_torch_kdl import VALID, tree

ASSEMBLIES = ("extension", "ctypes")

INVALID_CORPUS = [
    "}", "a {", "a { b", '"unterminated', 'esc "bad \\q escape"',
    'esc "bad \\u41"', 'esc "bad \\u{FFFFFFFF}"', "raw r#\"unterminated",
    "raw r#missing-quote", "/* unterminated", "(ty node 1", "a (ty",
    "num 0x", "num 0xZZ", "num 1.2.3.4e5e6", "a =1", "a ==",
    "deep" + " { x" * 200, "a #unknownkw", "a ٣", "a +٣", "a #é",
    'q "k"=1', "n k=(t)3",
]

PYTHON_ONLY_CORPUS = [
    "big 99999999999999999999999999999",
    "big -99999999999999999999999999999",
    "big k=170141183460469231731687303715884105727",
]


def python_parse(text):
    return port_kdl._Parser(text).parse_nodes()


def ref_python_parse(text):
    return ref_kdl._Parser(text).parse_nodes()


@pytest.fixture(params=ASSEMBLIES)
def assembly(request, monkeypatch):
    if request.param == "ctypes":
        monkeypatch.setenv("FLEET_KDL_ASSEMBLY", "ctypes")
    else:
        monkeypatch.delenv("FLEET_KDL_ASSEMBLY", raising=False)
    assert nk.assembly() == request.param
    return request.param


@pytest.mark.parametrize("text", VALID, ids=range(len(VALID)))
def test_valid_parity(text, assembly):
    want = tree(ref_python_parse(text))
    assert tree(python_parse(text)) == want
    native = nk.native_parse_document(text)
    if native is None:
        # only a guarded (non-ASCII) or overflowing document may refuse
        assert not text.isascii() or text.startswith("big "), text
    else:
        assert tree(native) == want
    assert tree(parse_document(text)) == want


@pytest.mark.parametrize("text", INVALID_CORPUS,
                         ids=range(len(INVALID_CORPUS)))
def test_invalid_never_silently_accepted(text, assembly):
    with pytest.raises(ref_kdl.KdlError) as ref_err:
        ref_python_parse(text)
    assert nk.native_parse_document(text) is None, text
    with pytest.raises(KdlError) as wired:
        parse_document(text)
    assert (str(wired.value), wired.value.line, wired.value.col) == \
        (str(ref_err.value), ref_err.value.line, ref_err.value.col)


@pytest.mark.parametrize("text", PYTHON_ONLY_CORPUS,
                         ids=range(len(PYTHON_ONLY_CORPUS)))
def test_python_only_documents_fall_back(text, assembly):
    assert nk.native_parse_document(text) is None
    assert tree(parse_document(text)) == tree(ref_python_parse(text))


def test_fleet_scale_document_parity(monkeypatch):
    """A 10k-service document: both assemblies and the Python parser give
    the reference's tree."""
    text = "".join(
        f'service "svc-{i}" {{\n'
        f'    image "registry.example/app:{i % 37}"\n'
        f'    port host={10000 + i} container=80 protocol="tcp"\n'
        f'    volume "./data-{i}" "/data" read-only=true\n'
        f'    cpu {1 + i % 4}\n    mem {256 * (1 + i % 8)}\n'
        f'    depends-on "svc-{max(0, i - 1)}"\n'
        f'    labels {{ tier "t{i % 5}" region "r{i % 3}" }}\n'
        f'}}\n' for i in range(10_000))
    want = tree(ref_kdl.parse_document(text))
    monkeypatch.delenv("FLEET_KDL_ASSEMBLY", raising=False)
    ext = nk.native_parse_document(text)
    monkeypatch.setenv("FLEET_KDL_ASSEMBLY", "ctypes")
    via_ctypes = nk.native_parse_document(text)
    assert len(ext) == 10_000
    assert tree(ext) == want and tree(via_ctypes) == want
    assert tree(python_parse(text)) == want


def test_wrapper_sets_every_kdlnode_field(assembly):
    assert [f.name for f in dataclasses.fields(port_kdl.KdlNode)] == \
        [f.name for f in dataclasses.fields(ref_kdl.KdlNode)] == \
        ["name", "args", "props", "children", "type_annotation", "line",
         "col"]
    node = nk.native_parse_document("(ty)n 1 k=2 { c }")[0]
    assert type(node) is port_kdl.KdlNode
    for f in dataclasses.fields(port_kdl.KdlNode):
        assert hasattr(node, f.name)
    assert (node.line, node.col) == (0, 0)


def test_fuzz_parity(assembly):
    """Random KDL-ish documents (seeded): native never accepts what Python
    rejects, and never gives another tree than the reference's parser."""
    rng = random.Random(42)
    atoms = ['node', 'a', '"str"', '1', '-2.5', '0x1F', 'true', '#null',
             'k=1', 'k="v"', '(t)', '(t)5', '/-', '{', '}', ';', '\n', ' ',
             '//c\n', '/*x*/', 'r#"raw"#', '\\\n', '"\\u{41}"', '"\\n"',
             '#inf', '+3', 'é', '"日本"', '0b11', '1_0', '..', '=', '(',
             ')', '"', '#']
    for _ in range(1000):
        doc = "".join(rng.choice(atoms) for _ in range(rng.randint(1, 12)))
        try:
            ref = tree(ref_python_parse(doc))
        except ref_kdl.KdlError:
            ref = None
        except RecursionError:
            continue
        nat = nk.native_parse_document(doc)
        if nat is None:
            continue
        assert ref is not None, f"native accepted {doc!r}"
        assert tree(nat) == ref, doc


def test_empty_string_offset_collision(assembly):
    text = '""node "" x=""\nnode ""'
    native = nk.native_parse_document(text)
    assert native is not None
    assert tree(native) == tree(ref_python_parse(text))


def test_env_knob_disables_native(monkeypatch):
    """FLEET_KDL_NATIVE=0: the Python parser, the native one never called."""
    def boom(text):
        raise AssertionError("native parser called")
    monkeypatch.setattr(nk, "native_parse_document", boom)
    monkeypatch.setenv("FLEET_KDL_NATIVE", "0")
    text = 'service "db" { image "postgres" }'
    assert tree(parse_document(text)) == tree(ref_python_parse(text))
    monkeypatch.setenv("FLEET_KDL_NATIVE", "1")
    with pytest.raises(AssertionError, match="native parser called"):
        parse_document(text)


def test_loader_path_uses_wired_parser(tmp_path, monkeypatch):
    from fleetflow_tpu_torch.core.loader import \
        load_project_from_root_with_stage
    from fleetflow_tpu_torch.core.serialize import flow_to_dict
    d = tmp_path / ".fleetflow"
    d.mkdir()
    (d / "fleet.kdl").write_text(
        'project "parity"\n'
        'service "db" { image "postgres" }\n'
        'stage "local" { service "db" }\n')
    calls = []
    real = nk.native_parse_document
    monkeypatch.setattr(nk, "native_parse_document",
                        lambda t: calls.append(t) or real(t))
    flow_native = load_project_from_root_with_stage(str(tmp_path))
    assert calls
    monkeypatch.setenv("FLEET_KDL_NATIVE", "0")
    flow_py = load_project_from_root_with_stage(str(tmp_path))
    # the FLEET_* process environment enters the variables; the rest equal
    native_d, py_d = flow_to_dict(flow_native), flow_to_dict(flow_py)
    assert py_d["variables"].pop("FLEET_KDL_NATIVE") == "0"
    assert native_d == py_d


def test_extension_is_abi_tagged():
    """The extension is built for this interpreter and named with its
    EXT_SUFFIX, beside the ctypes library, under _ext_build/."""
    mod = _ext.host_extension("ffkdlpy")
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    assert mod.__file__.endswith("ffkdlpy" + suffix)
    assert os.path.dirname(mod.__file__) == str(_ext._host_dir())
    assert (_ext._host_dir() / "libffkdl.so").is_file() or \
        nk.load() is not None
    assert nk.kdl_native_available() is True


@pytest.mark.parametrize("assembly_env", [None, "ctypes"])
def test_build_failure_raises(monkeypatch, tmp_path, assembly_env):
    """No library, no quiet fallback: with the compiler pointed at nothing
    and an empty build directory, the native path raises RuntimeError
    naming the compiler; FLEET_KDL_NATIVE=0 still parses in Python."""
    nk.load()
    _ext.host_extension("ffkdlpy")           # built where it belongs
    monkeypatch.setattr(_ext, "_host_libs", {})
    monkeypatch.setattr(_ext, "_host_exts", {})
    monkeypatch.setattr(nk, "_configured_lib", None)
    monkeypatch.setattr(_ext, "_BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    if assembly_env:
        monkeypatch.setenv("FLEET_KDL_ASSEMBLY", assembly_env)
    else:
        monkeypatch.delenv("FLEET_KDL_ASSEMBLY", raising=False)
    with pytest.raises(RuntimeError, match="not found"):
        parse_document('service "db" { image "postgres" }')
    with pytest.raises(RuntimeError):
        nk.kdl_native_available()
    monkeypatch.setenv("FLEET_KDL_NATIVE", "0")
    assert parse_document("a 1")[0].args == [1]


def test_missing_python_headers_raise(monkeypatch, tmp_path):
    """An interpreter without Python.h cannot build the extension: that is
    an error with its reason, not a quiet switch to the ctypes loop."""
    monkeypatch.setattr(_ext, "_host_exts", {})
    monkeypatch.setattr(_ext, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda *a, **k: {"include": str(tmp_path)})
    monkeypatch.delenv("FLEET_KDL_ASSEMBLY", raising=False)
    with pytest.raises(RuntimeError, match="Python.h"):
        nk.native_parse_document("a 1")
