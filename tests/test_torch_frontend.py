"""The port's front-end machinery against the reference's: the
content-addressed parse cache (memory LRU, disk tier, its metrics),
fragment merging, the loader pool's error path, the tokenizer corners, the
native Kahn dependency depths, and the import boundary (the front end
needs neither torch nor the reference).

Deliberate difference, tested here: the port's disk cache entries carry
the port's own tag in their file names and hashed keys, so one
FLEET_PARSE_CACHE directory serves both packages and neither unpickles the
other's entries (which would import the other package's model classes).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fleetflow_tpu.core import parsecache as ref_pc
from fleetflow_tpu.core import parser as ref_parser
from fleetflow_tpu.core import serialize as ref_ser
from fleetflow_tpu.lower.tensors import dependency_depths as ref_depths
from fleetflow_tpu_torch.core import kdl as port_kdl
from fleetflow_tpu_torch.core import parsecache as port_pc
from fleetflow_tpu_torch.core import parser as port_parser
from fleetflow_tpu_torch.core import serialize as port_ser
from fleetflow_tpu_torch.core.errors import FlowError
from fleetflow_tpu_torch.core.kdl import _Parser
from fleetflow_tpu_torch.core.loader import load_project_from_root_with_stage
from fleetflow_tpu_torch.lower.tensors import dependency_depths
from fleetflow_tpu_torch.native import native_dep_depths
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from torch_frontend_cases import REPO, run

parse = port_parser.parse_kdl_string


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    # tiny test texts must still flow through the cache
    monkeypatch.setenv("FLEET_PARSE_CACHE_MIN", "1")
    monkeypatch.delenv("FLEET_PARSE_CACHE", raising=False)
    monkeypatch.delenv("FLEET_PARSE_WORKERS", raising=False)
    monkeypatch.setattr(port_pc, "_default", None)
    monkeypatch.setattr(ref_pc, "_default", None)
    yield


def _lookups(outcome):
    return REGISTRY.counter("fleet_frontend_parse_cache_total",
                            labels=("outcome",)).value(outcome=outcome)


class TestParseCache:
    def test_disk_tier_round_trip(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_PARSE_CACHE", str(tmp_path / "pc"))
        text = 'service "a" { image "i:1" }\n' * 40
        misses0, disk0 = _lookups("miss"), _lookups("disk_hit")
        cold = parse(text)
        assert port_pc.default_parse_cache().misses == 1
        monkeypatch.setattr(port_pc, "_default", None)   # "a new process"
        warm = parse(text)
        assert port_pc.default_parse_cache().disk_hits == 1
        assert port_ser.flow_to_dict(warm) == port_ser.flow_to_dict(cold)
        assert (_lookups("miss") - misses0, _lookups("disk_hit") - disk0) \
            == (1, 1)
        hits0 = _lookups("hit")
        parse(text)
        assert _lookups("hit") - hits0 == 1

    def test_corrupt_disk_entry_is_a_miss(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_PARSE_CACHE", str(tmp_path / "pc"))
        text = 'service "z" { image "i" }\n' * 20
        parse(text)
        files = list((tmp_path / "pc").iterdir())
        assert len(files) == 1
        files[0].write_bytes(b"not a pickle")
        monkeypatch.setattr(port_pc, "_default", None)
        assert parse(text).services
        assert port_pc.default_parse_cache().misses == 1

    def test_lru_bound(self, monkeypatch):
        monkeypatch.setenv("FLEET_PARSE_CACHE_MEM", "2")
        for i in range(5):
            parse(f'service "s{i}" {{ image "i" }}\n')
        assert len(port_pc.default_parse_cache()._mem) <= 2

    def test_keys_equal_the_reference(self):
        text = 'service "a" { image "i" }\n'
        for args in ((False, None, 0), (False, "x", 7), (True, "f", 3)):
            assert port_pc.ParseCache.key(text, *args) == \
                ref_pc.ParseCache.key(text, *args)
        assert port_pc.ParseCache.key(text, False, None, 0) == \
            port_pc.ParseCache.key(text, False, "x", 7)
        f9 = parse(text, want_spans=True, line_offset=9)
        assert f9.services["a"].loc.line == 10

    def test_cached_fragment_not_mutated_by_merges(self):
        text = 'service "a" { image "i:1" }\nstage "s" { service "a" }\n'
        frag1 = parse(text)
        target = parse('service "a" { replicas 2 }', cache=False)
        parse(text, target)
        target.stages["s"].services.append("injected")
        frag2 = parse(text)
        assert frag2.stages["s"].services == ["a"]
        assert frag1.stages["s"].services == ["a"]
        frag2.services["a"].image = "mutated"
        assert parse(text).services["a"].image == "i:1"


class TestDiskIsolation:
    TEXT = 'service "shared" { image "i:1" }\nstage "s" { service "shared" }\n'

    def test_one_directory_two_packages(self, tmp_path, monkeypatch):
        """Both packages write their entry for the same text; each reads
        only its own (a miss on the other's), and the file names differ."""
        d = tmp_path / "pc"
        monkeypatch.setenv("FLEET_PARSE_CACHE", str(d))
        ref_parser.parse_kdl_string(self.TEXT)
        (ref_file,) = list(d.iterdir())
        parse(self.TEXT)
        assert port_pc.default_parse_cache().misses == 1
        port_files = [f for f in d.iterdir() if f != ref_file]
        assert len(port_files) == 1
        assert port_files[0].name.startswith(port_pc.CACHE_TAG + "-")
        assert not ref_file.name.startswith(port_pc.CACHE_TAG)
        # fresh caches on the shared directory: each hits its own entry
        monkeypatch.setattr(port_pc, "_default", None)
        monkeypatch.setattr(ref_pc, "_default", None)
        port_flow = parse(self.TEXT)
        ref_flow = ref_parser.parse_kdl_string(self.TEXT)
        assert port_pc.default_parse_cache().disk_hits == 1
        assert ref_pc.default_parse_cache().disk_hits == 1
        assert type(port_flow).__module__ == "fleetflow_tpu_torch.core.model"
        assert port_ser.flow_to_dict(port_flow) == \
            ref_ser.flow_to_dict(ref_flow)

    def test_fresh_interpreter_never_imports_the_reference(self, tmp_path,
                                                           monkeypatch):
        """A process of the port alone, on a directory that holds the
        reference's entry for its text: a miss (the reference's pickle is
        never opened), its own entry written, and no fleetflow_tpu, jax or
        torch module loaded; a second such process hits its entry."""
        d = tmp_path / "pc"
        monkeypatch.setenv("FLEET_PARSE_CACHE", str(d))
        ref_parser.parse_kdl_string(self.TEXT)
        code = (
            "import sys\n"
            "from fleetflow_tpu_torch.core import parse_kdl_string\n"
            "from fleetflow_tpu_torch.core.parsecache import "
            "default_parse_cache\n"
            f"f = parse_kdl_string({self.TEXT!r})\n"
            "pc = default_parse_cache()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('fleetflow_tpu', 'jax', 'jaxlib', 'torch'))\n"
            "print(pc.misses, pc.disk_hits, list(f.services), bad)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   FLEET_PARSE_CACHE=str(d), FLEET_PARSE_CACHE_MIN="1")
        outs = [subprocess.run([sys.executable, "-c", code], cwd=REPO,
                               env=env, capture_output=True, text=True,
                               timeout=120) for _ in range(2)]
        for out in outs:
            assert out.returncode == 0, out.stderr
        assert outs[0].stdout.split() == ["1", "0", "['shared']", "[]"]
        assert outs[1].stdout.split() == ["0", "1", "['shared']", "[]"]
        assert len(list(d.iterdir())) == 2


class TestMetrics:
    def test_phase_gauge_is_one_family(self):
        """The loader's gauge and the solver's are the same family, with
        the reference's name, HELP and labels."""
        from fleetflow_tpu_torch.solver import api
        assert api._M_FRONTEND_MS is port_pc.M_FRONTEND_PHASE_MS
        for port_m, ref_m in ((port_pc.M_FRONTEND_PHASE_MS,
                               ref_pc.M_FRONTEND_PHASE_MS),
                              (port_pc._M_CACHE, ref_pc._M_CACHE)):
            assert (port_m.name, port_m.help, port_m.labelnames) == \
                (ref_m.name, ref_m.help, ref_m.labelnames)

    def test_loader_sets_the_parse_phase(self, tmp_path):
        cfg = tmp_path / ".fleetflow"
        cfg.mkdir()
        (cfg / "fleet.kdl").write_text('service "a" { }\n')
        port_pc.M_FRONTEND_PHASE_MS.set(-1.0, phase="parse")
        load_project_from_root_with_stage(str(tmp_path), environ={})
        assert port_pc.M_FRONTEND_PHASE_MS.value(phase="parse") >= 0.0


FRAGMENTS = [
    ('project "x"\nservice "a" { image "i:1" }\n',
     'service "a" { replicas 3 }\nstage "s" { service "a" }\n'),
    ('stage "s" { service "a"; server "n1" }\nservice "a" { image "i" }\n',
     'stage "s" { service "b" { image "j" } server "n2" }\n'
     'service "b" { image "k" }\n'),
    ('variables { A "1"; B "2" }\nregistry "r.example/one"\n',
     'variables { B "3" }\ntenant "acme" { display_name "Acme" }\n'
     'provider "sakura" { zone "tk1a" }\n'),
    ('server "n1" { capacity { cpu 4 } }\n',
     'server "n1" { capacity { cpu 8 } }\nproject "late-name"\n'),
]


@pytest.mark.parametrize("a,b", FRAGMENTS, ids=range(len(FRAGMENTS)))
def test_fragment_merge_parity(a, b):
    """Concatenated parse == per-fragment merge, in each package, and the
    port's equals the reference's."""
    out = []
    for pkg, ser in ((ref_parser, ref_ser), (port_parser, port_ser)):
        whole = pkg.parse_kdl_string(a + "\n" + b, cache=False)
        merged = pkg.parse_kdl_string(b, pkg.parse_kdl_string(a, cache=False),
                                      cache=False)
        out.append((ser.flow_to_dict(whole), ser.flow_to_dict(merged),
                    len(merged.redefinitions)))
    assert out[1] == out[0]
    assert out[1][0].get("services") == out[1][1].get("services")


def test_fragment_internals_parity():
    for fn in (lambda p: p._parse_kdl_fragment("ok\n}", line_offset=10),
               lambda p: p._parse_kdl_fragment('a "x', line_offset=3)):
        got, want = run(fn, port_parser), run(fn, ref_parser)
        assert got == want and got[0] == "error"
    with pytest.raises(FlowError, match="12:1"):
        port_parser._parse_kdl_fragment("ok\n}", line_offset=10)
    a = parse('service "a" { image "one" }', cache=False)
    port_parser.merge_flow_fragment(
        a, port_parser._parse_kdl_fragment('service "a" { image "two" }'))
    assert a.services["a"].image == "two" and len(a.redefinitions) == 1


def test_parse_error_propagates_from_pool(tmp_path, monkeypatch):
    cfg = tmp_path / ".fleetflow" / "services"
    cfg.mkdir(parents=True)
    (cfg.parent / "fleet.kdl").write_text(
        'project "p"\n' + 'service "x" { image "i" }\n' * 200)
    (cfg / "a.kdl").write_text('service "broken" {\n' +
                               'image "i"\n' * 300)
    monkeypatch.setenv("FLEET_PARSE_WORKERS", "2")
    from fleetflow_tpu.core.loader import \
        load_project_from_root_with_stage as ref_load
    want = run(ref_load, str(tmp_path), environ={})
    got = run(load_project_from_root_with_stage, str(tmp_path), environ={})
    assert got == want and got[0] == "error"


@pytest.mark.parametrize("doc", [
    "//c\n;", "a ٣", 'a r"raw" r#"h#sh"#', 'n k=#true v=0x1f w="s" true',
    'n "plain" "es\\tc\\u{41}" r"raw\\no-escape"', "n 0x", "n 1e",
    "n 1.2.3", "n +", "a. ٣", "a .٣"])
def test_tokenizer_corners_parity(doc):
    from fleetflow_tpu.core.kdl import _Parser as RefParser
    from test_torch_kdl import outcome
    assert outcome(lambda t: _Parser(t).parse_nodes(), doc) == \
        outcome(lambda t: RefParser(t).parse_nodes(), doc)
    assert outcome(port_kdl.parse_document, doc) == \
        outcome(lambda t: RefParser(t).parse_nodes(), doc)


def _random_dag(S, seed, density):
    rng = np.random.default_rng(seed)
    order = rng.permutation(S)
    adj = np.zeros((S, S), dtype=bool)
    src, dst = np.nonzero(np.triu(rng.random((S, S)) < density, 1))
    adj[order[dst], order[src]] = True     # later in `order` depends on earlier
    return adj


@pytest.mark.parametrize("S,seed,density", [(1, 0, 0.0), (50, 1, 0.05),
                                            (400, 2, 0.01), (2000, 3, 0.001),
                                            (300, 4, 0.0)])
def test_native_dep_depths_parity(S, seed, density):
    """ff_dep_depths (csrc/host/placer.cpp) gives the Kahn levels of
    dependency_depths, in both packages."""
    adj = _random_dag(S, seed, density)
    want = ref_depths(adj)
    assert np.array_equal(dependency_depths(adj), want)
    got = native_dep_depths(adj)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    from fleetflow_tpu.native.lib import load as ref_load
    from fleetflow_tpu.native.lib import native_dep_depths as ref_native
    if ref_load() is not None:
        assert np.array_equal(ref_native(adj), got)


def test_native_dep_depths_cycle_raises():
    adj = np.zeros((4, 4), dtype=bool)
    adj[0, 1] = adj[1, 2] = adj[2, 0] = True
    with pytest.raises(ValueError, match="cycle"):
        native_dep_depths(adj)


def test_front_end_imports_no_torch():
    """The front end (core/, lower/, native/kdl) parses and lowers in a
    fresh interpreter without torch, jax or the reference: the loader's
    forked workers never touch CUDA."""
    code = (
        "import sys\n"
        "from fleetflow_tpu_torch.core import parse_kdl_string\n"
        "from fleetflow_tpu_torch.core import loader, template, secrets\n"
        "from fleetflow_tpu_torch.lower import lower_stage, fleetgen\n"
        "from fleetflow_tpu_torch.native import kdl, native_dep_depths\n"
        "f = parse_kdl_string(fleetgen.generate_fleet_kdl('t', 50, "
        "n_nodes_hint=8))\n"
        "pt = lower_stage(f, 'prod')\n"
        "native_dep_depths(pt.dep_adj)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'fleetflow_tpu'))\n"
        "print(pt.S, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
