"""The port's multi-fleet registry (fleetflow_tpu_torch.registry: the
parser, discovery and the aggregation of every fleet x stage into one
placement instance) against the reference's, on the CPU.

- parsing: ``parse_registry_string`` of examples/production's
  fleet-registry.kdl and of a generated registry equals the reference's
  Registry field for field;
- aggregation: an 8-fleet fleetgen registry (8 x 50 services, 40 nodes, two
  routes) loaded from project directories aggregates to the same
  ProblemTensors, every array bit for bit, and the same AggregateIndex rows;
  after a one-fleet edit both packages' FlowCaches count the same hits and
  misses and the instances stay equal; a forked pool of 2 loaders
  (FLEET_PARSE_WORKERS=2) gives the serial instance;
- the content hashes (``fleet_stage_hashes``, ``fleet_content_hash``)
  equal the reference's, include-following corners included;
- the lowered-instance disk tier of both packages in one FLEET_PARSE_CACHE
  directory: each package hits its own entries and opens none of the
  other's;
- the reference's own registry and aggregation tests
  (tests/test_registry_build_cloud.py's TestRegistryParser and
  TestAggregate; tests/test_frontend.py's TestMutateOneFileEquivalence,
  TestStageHashGrain and TestInstanceDiskTier) on the port;
- the instance placed by the card's scheduler (``device="cpu"``: its plain
  versions), a one-fleet edit re-placed warm from the previous placement
  by row name, and chip_smoke's [registry] phase rehearsed at a small size.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from fleetflow_tpu.core import parsecache as ref_pc
from fleetflow_tpu.core.parser import parse_kdl_string as ref_parse
from fleetflow_tpu.lower import fleetgen as ref_fleetgen
from fleetflow_tpu.registry import aggregate as ref_agg
from fleetflow_tpu.registry import parser as ref_parser
from fleetflow_tpu_torch.core import parsecache as port_pc
from fleetflow_tpu_torch.core.parser import parse_kdl_string
from fleetflow_tpu_torch.lower import fleetgen
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.registry import (aggregate_fleets, find_registry,
                                          parse_registry_file,
                                          parse_registry_string)
from fleetflow_tpu_torch.registry import aggregate as port_agg
from fleetflow_tpu_torch.registry.aggregate import (FlowCache,
                                                    fleet_content_hash,
                                                    fleet_stage_hashes)
from fleetflow_tpu_torch.registry.model import FleetEntry, Registry
from torch_frontend_cases import EXAMPLES, REPO, tensor_diff

F, S_FLEET, N_NODES = 8, 50, 40


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    # tiny test files must still flow through the cache (as the
    # reference's front-end tests set it)
    monkeypatch.setenv("FLEET_PARSE_CACHE_MIN", "1")
    monkeypatch.delenv("FLEET_PARSE_CACHE", raising=False)
    monkeypatch.delenv("FLEET_PARSE_WORKERS", raising=False)
    monkeypatch.delenv("FLEET_REGISTRY", raising=False)
    for pc in (ref_pc, port_pc):
        pc.parse_cache_clear()
    yield
    for pc in (ref_pc, port_pc):
        pc.parse_cache_clear()


def plain(v):
    """A value of either package as plain data: dataclasses by field,
    enums by value."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def fleet_text(i: int, n: int = S_FLEET, nodes: int = N_NODES) -> str:
    return fleetgen.generate_fleet_kdl(f"t{i}", n, seed=100 + i,
                                       n_nodes_hint=nodes,
                                       port_base=10000 + i * n)


def write_fleet(root, i: int, n: int = S_FLEET) -> str:
    proj = root / f"t{i}" / ".fleetflow"
    proj.mkdir(parents=True, exist_ok=True)
    (proj / "fleet.kdl").write_text(fleet_text(i, n))
    return str(root / f"t{i}")


def write_registry(root, fleets: int = F, nodes: int = N_NODES,
                   routes=(("t1", "node-0003"), ("t5", "node-0011"))) -> str:
    """`fleets` fleetgen fleets as project directories under `root`, and a
    fleet-registry.kdl naming them, `nodes` generated servers and the
    routes (fleet, server) of each fleet's "prod" stage."""
    lines = [f'fleet "t{i}" path="{write_fleet(root, i)}"'
             for i in range(fleets)]
    lines.append(fleetgen.generate_servers_kdl(nodes, seed=7))
    lines += [f'route fleet="{f}" stage="prod" server="{s}"'
              for f, s in routes]
    path = root / "fleet-registry.kdl"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def aggregate_both(path: str, ref_cache=None, port_cache=None):
    stages = {f"t{i}": ["prod"] for i in range(F)}
    ref = ref_agg.aggregate_fleets(ref_parser.parse_registry_file(path),
                                   stages=stages, cache=ref_cache)
    port = aggregate_fleets(parse_registry_file(path), stages=stages,
                            cache=port_cache)
    return ref, port


def assert_instances_equal(ref, port):
    (ref_pt, ref_ix), (pt, ix) = ref, port
    assert tensor_diff(ref_pt, pt) == []
    assert ix.rows == ref_ix.rows


# --------------------------------------------------------------------------
# parsing
# --------------------------------------------------------------------------

def test_production_example_registry_equal():
    text = (EXAMPLES / "production" / "fleet-registry.kdl").read_text()
    ref = ref_parser.parse_registry_string(text, source="x")
    port = parse_registry_string(text, source="x")
    assert plain(port) == plain(ref)
    assert [r.server for r in port.routes] == ["tokyo-1"]


def test_generated_registry_equal(tmp_path):
    path = write_registry(tmp_path)
    ref = ref_parser.parse_registry_file(path)
    port = parse_registry_file(path)
    assert plain(port) == plain(ref)
    assert len(port.servers) == N_NODES and len(port.fleets) == F
    assert port.source == path


@pytest.mark.parametrize("bad", [
    'fleet "x"\n', 'fleet path="/p"\n', 'route fleet="a"\n',
    'fleet "a" path="/a"\nroute fleet="a" stage="s" server="ghost"\n'])
def test_parse_errors_equal(bad):
    def run(fn):
        try:
            fn(bad)
        except Exception as e:     # noqa: BLE001 - compared, not swallowed
            return type(e).__name__, str(e)
        return None
    got = run(parse_registry_string)
    assert got is not None and got == run(ref_parser.parse_registry_string)


# --------------------------------------------------------------------------
# aggregation parity
# --------------------------------------------------------------------------

def test_aggregate_bit_identical_with_routes(tmp_path):
    path = write_registry(tmp_path)
    ref_cache, port_cache = ref_agg.FlowCache(), FlowCache()
    ref, port = aggregate_both(path, ref_cache, port_cache)
    assert_instances_equal(ref, port)
    pt, ix = port
    assert pt.N == N_NODES and pt.S > F * S_FLEET   # replicas expanded
    assert (pt.port_ids >= 0).any() and (pt.volume_ids >= 0).any()
    # the routes pin every row of their stage to the routed server
    j = pt.node_names.index("node-0003")
    pinned = [i for i, r in enumerate(ix.rows) if r[0] == "t1"]
    assert pinned and all(pt.eligible[i].sum() == 1 and pt.eligible[i, j]
                          for i in pinned)
    assert port_cache.stats() == ref_cache.stats() == {
        "hits": 0, "misses": F, "entries": F, "instance_hits": 0}

    # an unchanged registry: the whole-instance hit in both
    ref2, port2 = aggregate_both(path, ref_cache, port_cache)
    assert port2[0] is pt and port_cache.stats() == ref_cache.stats()

    # a one-fleet edit (3 fewer services): one miss, seven hits
    write_fleet(tmp_path, 0, S_FLEET - 3)
    ref3, port3 = aggregate_both(path, ref_cache, port_cache)
    assert_instances_equal(ref3, port3)
    assert port_cache.stats() == ref_cache.stats() == {
        "hits": 2 * F - 1, "misses": F + 1, "entries": F,
        "instance_hits": 1}
    assert port3[0].S < pt.S


def test_fork_pool_equals_serial(tmp_path, monkeypatch):
    path = write_registry(tmp_path)
    serial = aggregate_fleets(parse_registry_file(path),
                              stages={f"t{i}": ["prod"] for i in range(F)},
                              cache=FlowCache())
    port_pc.parse_cache_clear()
    monkeypatch.setenv("FLEET_PARSE_WORKERS", "2")
    cache = FlowCache()
    pooled = aggregate_fleets(parse_registry_file(path),
                              stages={f"t{i}": ["prod"] for i in range(F)},
                              cache=cache)
    assert cache.misses == F
    assert_instances_equal(serial, pooled)
    ref = ref_agg.aggregate_fleets(
        ref_parser.parse_registry_file(path),
        stages={f"t{i}": ["prod"] for i in range(F)})
    assert_instances_equal(ref, pooled)


def test_pool_raises_a_fleet_parse_error(tmp_path, monkeypatch):
    from fleetflow_tpu_torch.core.errors import FlowError
    path = write_registry(tmp_path)
    (tmp_path / "t2" / ".fleetflow" / "fleet.kdl").write_text(
        'service "broken" {\n')
    monkeypatch.setenv("FLEET_PARSE_WORKERS", "2")
    with pytest.raises(FlowError):
        aggregate_fleets(parse_registry_file(path),
                         stages={f"t{i}": ["prod"] for i in range(F)},
                         cache=FlowCache())


def test_default_stages_and_loader_injection(tmp_path):
    """Without `stages`: a routed fleet aggregates its routed stages, the
    others every stage a stage-neutral load finds; an injected loader
    and a one-parameter content hash give the reference's instance."""
    path = write_registry(tmp_path, fleets=3, routes=(("t1", "node-0002"),))
    texts = {str(tmp_path / f"t{i}"): fleet_text(i) for i in range(3)}
    versions = {p: "v1" for p in texts}
    ref_pt, ref_ix = ref_agg.aggregate_fleets(
        ref_parser.parse_registry_file(path))
    pt, ix = aggregate_fleets(parse_registry_file(path))
    assert tensor_diff(ref_pt, pt) == [] and ix.rows == ref_ix.rows
    cache, ref_cache = FlowCache(), ref_agg.FlowCache()
    for _ in range(2):
        got = aggregate_fleets(
            parse_registry_file(path), cache=cache,
            loader=lambda p, s: parse_kdl_string(texts[p], cache=False),
            content_hash=lambda p: versions[p])
        want = ref_agg.aggregate_fleets(
            ref_parser.parse_registry_file(path), cache=ref_cache,
            loader=lambda p, s: ref_parse(texts[p], cache=False),
            content_hash=lambda p: versions[p])
        assert tensor_diff(want[0], got[0]) == [] and got[1].rows == \
            want[1].rows
    assert cache.stats() == ref_cache.stats()
    assert tensor_diff(pt, got[0]) == []


def test_stage_hashes_equal(tmp_path, monkeypatch):
    root = tmp_path / "fleet"
    shared = tmp_path / "shared"
    shared.mkdir()
    _write_project(root, 3)
    (shared / "frag.kdl").write_text('include "deep.kdl"\n')
    (shared / "deep.kdl").write_text(_svc("shared-2", 0.1, 64.0))
    cfg = root / ".fleetflow"
    (cfg / "flow.prod.kdl").write_text('include "../../shared/frag.kdl"\n')
    (cfg / ".env.dev").write_text("A=1\n")
    monkeypatch.setenv("FLEET_REGISTRY_TEST_KNOB", "on")
    for target in (str(root), str(cfg / "fleet.kdl")):
        for stages in (["prod"], ["prod", "dev"], ["dev", "qa"]):
            assert fleet_stage_hashes(target, stages) == \
                ref_agg.fleet_stage_hashes(target, stages)
        assert fleet_content_hash(target) == \
            ref_agg.fleet_content_hash(target)
        assert port_agg.fleet_stage_content_hash(target, "prod") == \
            ref_agg.fleet_stage_content_hash(target, "prod")


def test_disk_tiers_share_a_directory(tmp_path, monkeypatch):
    """One FLEET_PARSE_CACHE directory: each package reuses its own
    lowered instances and never opens the other's."""
    cache_dir = tmp_path / "pc"
    monkeypatch.setenv("FLEET_PARSE_CACHE", str(cache_dir))
    path = write_registry(tmp_path)
    aggregate_both(path, ref_agg.FlowCache(), FlowCache())
    ref_files = sorted(p.name for p in cache_dir.glob("instance-*.pkl"))
    port_files = sorted(p.name for p in cache_dir.glob(
        "fleetflow_tpu_torch-instance-*.pkl"))
    assert len(ref_files) == 1 and len(port_files) == 1

    ref_cache, port_cache = ref_agg.FlowCache(), FlowCache()
    ref, port = aggregate_both(path, ref_cache, port_cache)
    assert ref_cache.instance_hits == 1 and port_cache.instance_hits == 1
    assert type(port[0]).__module__ == "fleetflow_tpu_torch.lower.tensors"
    assert type(ref[0]).__module__ == "fleetflow_tpu.lower.tensors"
    assert_instances_equal(ref, port)

    # without its own entry, neither package takes the other's
    (cache_dir / port_files[0]).unlink()
    port_cache = FlowCache()
    aggregate_fleets(parse_registry_file(path),
                     stages={f"t{i}": ["prod"] for i in range(F)},
                     cache=port_cache)
    assert port_cache.instance_hits == 0 and port_cache.misses == F
    (cache_dir / ref_files[0]).unlink()
    ref_cache = ref_agg.FlowCache()
    ref_agg.aggregate_fleets(ref_parser.parse_registry_file(path),
                             stages={f"t{i}": ["prod"] for i in range(F)},
                             cache=ref_cache)
    assert ref_cache.instance_hits == 0 and ref_cache.misses == F


def test_instance_signature_hashes_the_ports_files():
    port_agg._code_sig = None
    sig = port_agg._instance_code_sig()
    import hashlib

    from fleetflow_tpu_torch.core import model
    from fleetflow_tpu_torch.lower import tensors
    h = hashlib.sha256()
    for src in (tensors.__file__, model.__file__, port_agg.__file__):
        with open(src, "rb") as f:
            h.update(f.read())
    assert sig == h.hexdigest() != ref_agg._instance_code_sig()


def test_lower_phase_gauge_is_set(tmp_path):
    gauge = REGISTRY.get("fleet_frontend_phase_ms")
    gauge.set(-1.0, phase="lower")
    path = write_registry(tmp_path, fleets=2, routes=())
    aggregate_fleets(parse_registry_file(path))
    assert gauge.value(phase="lower") > 0.0
    counter = REGISTRY.get("fleet_registry_flow_cache_total")
    before = {o: counter.value(outcome=o) for o in ("hit", "miss")}
    cache = FlowCache()
    aggregate_fleets(parse_registry_file(path), cache=cache)
    write_fleet(tmp_path, 0, S_FLEET - 1)
    aggregate_fleets(parse_registry_file(path), cache=cache)
    assert counter.value(outcome="miss") - before["miss"] == 3
    assert counter.value(outcome="hit") - before["hit"] == 1


def test_aggregate_imports_no_torch():
    """The fork pool's workers never touch CUDA: the aggregation imports
    no torch (nor the reference)."""
    code = ("import sys\n"
            "import fleetflow_tpu_torch.registry.aggregate\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'fleetflow_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --------------------------------------------------------------------------
# the reference's registry tests on the port
# (tests/test_registry_build_cloud.py TestRegistryParser, TestAggregate)
# --------------------------------------------------------------------------

REGISTRY_KDL = '''
fleet "blog" path="/tmp/fleets/blog" description="the blog"
fleet "shop" path="/tmp/fleets/shop" tenant="acme"

server "web-1" {
    capacity { cpu 8; memory 16384; disk 100000 }
    labels { tier "standard" }
}
server "web-2" {
    capacity { cpu 8; memory 16384; disk 100000 }
}

route fleet="blog" stage="live" server="web-1"
route fleet="shop" stage="live" server="web-2"
'''


class TestRegistryParser:
    def test_parse_and_queries(self):
        reg = parse_registry_string(REGISTRY_KDL)
        assert set(reg.fleets) == {"blog", "shop"}
        assert reg.fleets["shop"].tenant == "acme"
        assert set(reg.servers) == {"web-1", "web-2"}
        assert reg.servers["web-1"].capacity.cpu == 8
        r = reg.resolve_route("blog", "live")
        assert r is not None and r.server == "web-1"
        assert reg.resolve_route("blog", "nope") is None
        assert [r.fleet for r in reg.routes_for_server("web-2")] == ["shop"]
        assert plain(reg) == plain(
            ref_parser.parse_registry_string(REGISTRY_KDL))

    def test_route_integrity(self):
        bad = REGISTRY_KDL + '\nroute fleet="ghost" stage="live" server="web-1"'
        with pytest.raises(ValueError, match="unknown.*fleet"):
            parse_registry_string(bad)
        bad2 = REGISTRY_KDL + '\nroute fleet="blog" stage="x" server="ghost"'
        with pytest.raises(ValueError, match="unknown.*server"):
            parse_registry_string(bad2)

    def test_discovery_walk_up(self, tmp_path, monkeypatch):
        deep = tmp_path / "a" / "b" / "c"
        deep.mkdir(parents=True)
        (tmp_path / "fleet-registry.kdl").write_text("")
        found = find_registry(str(deep))
        assert found == tmp_path / "fleet-registry.kdl"
        (deep / ".fleetflow").mkdir()
        (deep / ".fleetflow" / "fleet-registry.kdl").write_text("")
        assert find_registry(str(deep)) == \
            deep / ".fleetflow" / "fleet-registry.kdl"
        monkeypatch.setenv("FLEET_REGISTRY", str(tmp_path / "nope.kdl"))
        assert find_registry(str(deep)) is None
        monkeypatch.setenv("FLEET_REGISTRY",
                           str(tmp_path / "fleet-registry.kdl"))
        assert find_registry(str(deep)) == tmp_path / "fleet-registry.kdl"


def make_fleet(name: str, n_services: int, base_port: int):
    from fleetflow_tpu_torch.core.model import (Flow, Port, ResourceSpec,
                                                Service, Stage)
    flow = Flow(name=name)
    names = [f"svc{i}" for i in range(n_services)]
    for i, sname in enumerate(names):
        flow.services[sname] = Service(
            name=sname, image=f"{name}-{sname}",
            ports=[Port(host=base_port + i, container=80)] if i == 0 else [],
            depends_on=[names[i - 1]] if i else [],
            resources=ResourceSpec(cpu=0.2, memory=128), _resources_set=True)
    flow.stages["live"] = Stage(name="live", services=names)
    return flow


class TestAggregate:
    @pytest.mark.parametrize("card", [False, True], ids=["host", "card"])
    def test_multi_fleet_single_instance(self, card):
        from fleetflow_tpu_torch.sched import (GpuSolverScheduler,
                                               HostGreedyScheduler)
        from fleetflow_tpu_torch.solver.repair import verify
        reg = parse_registry_string(REGISTRY_KDL)
        fleets = {"blog": make_fleet("blog", 3, 18000),
                  "shop": make_fleet("shop", 4, 18000)}   # same host ports!
        pt, index = aggregate_fleets(
            reg, loader=lambda path, stage: fleets[path.rsplit("/", 1)[-1]])
        assert pt.S == 7
        assert pt.node_names == ["web-1", "web-2"]
        assert ("blog", "live", "svc0") in index.rows
        i_blog = index.rows.index(("blog", "live", "svc0"))
        assert pt.eligible[i_blog].tolist() == [True, False]
        sched = (GpuSolverScheduler(device="cpu") if card
                 else HostGreedyScheduler())
        placement = sched.place(pt)
        assert placement.feasible
        assert verify(pt, placement.raw)["total"] == 0
        slices = index.slices_for_node(pt, placement.raw, "web-1")
        assert ("blog", "live") in slices
        assert sorted(slices[("blog", "live")]) == ["svc0", "svc1", "svc2"]
        assert pt.dep_depth.max() >= 2

    def test_port_conflict_across_fleets(self):
        from fleetflow_tpu_torch.sched import HostGreedyScheduler
        reg = parse_registry_string('''
fleet "a" path="/f/a"
fleet "b" path="/f/b"
server "n1" { capacity { cpu 8; memory 16384; disk 100000 } }
server "n2" { capacity { cpu 8; memory 16384; disk 100000 } }
''')
        fleets = {"a": make_fleet("a", 1, 9000), "b": make_fleet("b", 1, 9000)}
        pt, index = aggregate_fleets(
            reg, loader=lambda path, stage: fleets[path.rsplit("/", 1)[-1]])
        placement = HostGreedyScheduler().place(pt)
        assert placement.feasible
        assert len(set(placement.assignment.values())) == 2


# --------------------------------------------------------------------------
# the reference's front-end aggregation tests on the port
# (tests/test_frontend.py)
# --------------------------------------------------------------------------

def _svc(name: str, cpu: float, mem: float, dep: str = None) -> str:
    dep_line = f'\n    depends_on "{dep}"' if dep else ""
    return (f'service "{name}" {{\n'
            f'    image "registry.example/app:1.0"\n'
            f'    resources {{ cpu {cpu}; memory {mem}; disk 10 }}'
            f'{dep_line}\n}}\n')


def _write_project(root, seed: int, n_per_file: int = 6) -> None:
    rng = np.random.default_rng(seed)
    cfg = root / ".fleetflow"
    (cfg / "services").mkdir(parents=True, exist_ok=True)

    def block(prefix, n):
        return "".join(
            _svc(f"{prefix}-{i}", round(float(rng.uniform(0.1, 0.5)), 3),
                 round(float(rng.uniform(64, 256)), 1))
            for i in range(n))

    names = [f"a-{i}" for i in range(n_per_file)] + \
            [f"b-{i}" for i in range(n_per_file)]
    stage = ('stage "prod" {\n'
             + "".join(f'    service "{n}"\n' for n in names)
             + "}\n"
             'stage "dev" {\n    service "a-0"\n}\n')
    (cfg / "fleet.kdl").write_text(f'project "p{seed}"\n' + stage)
    (cfg / "services" / "a.kdl").write_text(block("a", n_per_file))
    (cfg / "services" / "b.kdl").write_text(block("b", n_per_file))
    (cfg / "flow.prod.kdl").write_text(
        'service "a-0" { labels { tier "hot" } }\n')


def _servers():
    txt = "".join(
        f'server "n{j}" {{ capacity {{ cpu 8; memory 4096; disk 500 }} }}\n'
        for j in range(4))
    return parse_kdl_string(txt, cache=False).servers


def _registry(root) -> Registry:
    return Registry(fleets={"f": FleetEntry(name="f", path=str(root))},
                    servers=_servers())


class TestMutateOneFileEquivalence:
    @pytest.mark.parametrize("seed", range(6))
    def test_bit_identical_tensors(self, tmp_path, seed):
        _write_project(tmp_path, seed)
        reg = _registry(tmp_path)
        cache = FlowCache()
        stages = {"f": ["prod"]}
        pt_cold, _ = aggregate_fleets(reg, stages=stages, cache=cache)
        pt_warm, _ = aggregate_fleets(reg, stages=stages, cache=cache)
        assert pt_warm is pt_cold
        assert cache.instance_hits == 1
        b = tmp_path / ".fleetflow" / "services" / "b.kdl"
        b.write_text(b.read_text().replace("cpu 0.", "cpu 0.9", 1))
        pt_mut, _ = aggregate_fleets(reg, stages=stages, cache=cache)
        assert pt_mut is not pt_cold
        port_pc.parse_cache_clear()
        pt_fresh, _ = aggregate_fleets(reg, stages=stages,
                                       cache=FlowCache())
        assert tensor_diff(pt_mut, pt_fresh) == []
        ref_pt, _ = ref_agg.aggregate_fleets(_ref_registry(tmp_path),
                                             stages=stages)
        assert tensor_diff(ref_pt, pt_mut) == []


def _ref_registry(root):
    from fleetflow_tpu.core.parser import parse_kdl_string as ref_parse
    from fleetflow_tpu.registry.model import FleetEntry as RefEntry
    from fleetflow_tpu.registry.model import Registry as RefRegistry
    txt = "".join(
        f'server "n{j}" {{ capacity {{ cpu 8; memory 4096; disk 500 }} }}\n'
        for j in range(4))
    return RefRegistry(fleets={"f": RefEntry(name="f", path=str(root))},
                       servers=ref_parse(txt, cache=False).servers)


class TestStageHashGrain:
    def test_stage_overlay_edit_invalidates_one_stage(self, tmp_path):
        _write_project(tmp_path, 1)
        h1 = fleet_stage_hashes(str(tmp_path), ["prod", "dev"])
        (tmp_path / ".fleetflow" / "flow.prod.kdl").write_text(
            'service "a-0" { labels { tier "cold" } }\n')
        h2 = fleet_stage_hashes(str(tmp_path), ["prod", "dev"])
        assert h1["prod"] != h2["prod"]
        assert h1["dev"] == h2["dev"]

    def test_common_edit_invalidates_every_stage(self, tmp_path):
        _write_project(tmp_path, 1)
        h1 = fleet_stage_hashes(str(tmp_path), ["prod", "dev"])
        p = tmp_path / ".fleetflow" / "services" / "a.kdl"
        p.write_text(p.read_text() + "// touched\n")
        h2 = fleet_stage_hashes(str(tmp_path), ["prod", "dev"])
        assert h1["prod"] != h2["prod"]
        assert h1["dev"] != h2["dev"]

    def test_flowcache_reloads_only_changed_stage(self, tmp_path):
        _write_project(tmp_path, 2)
        reg = _registry(tmp_path)
        cache = FlowCache()
        stages = {"f": ["dev", "prod"]}
        aggregate_fleets(reg, stages=stages, cache=cache)
        assert cache.misses == 2
        (tmp_path / ".fleetflow" / "flow.prod.kdl").write_text(
            'service "a-0" { labels { tier "cold" } }\n')
        aggregate_fleets(reg, stages=stages, cache=cache)
        assert cache.hits == 1 and cache.misses == 3

    def test_out_of_root_include_edit_invalidates(self, tmp_path):
        root = tmp_path / "fleet"
        shared = tmp_path / "shared"
        shared.mkdir()
        _write_project(root, 4)
        (shared / "common.kdl").write_text(_svc("shared-0", 0.1, 64.0))
        (shared / "nested.kdl").write_text(_svc("shared-1", 0.1, 64.0)
                                           + 'include "deep.kdl"\n')
        (shared / "deep.kdl").write_text(_svc("shared-2", 0.1, 64.0))
        cfg = root / ".fleetflow"
        (cfg / "services" / "inc.kdl").write_text(
            'include "../../../shared/common.kdl" '
            '"../../../shared/nested.kdl"\n')
        h1 = fleet_content_hash(str(root))
        s1 = fleet_stage_hashes(str(root), ["prod", "dev"])
        (shared / "common.kdl").write_text(_svc("shared-0", 0.4, 64.0))
        h2 = fleet_content_hash(str(root))
        s2 = fleet_stage_hashes(str(root), ["prod", "dev"])
        assert h1 != h2
        assert s1["prod"] != s2["prod"] and s1["dev"] != s2["dev"]
        (shared / "deep.kdl").write_text(_svc("shared-2", 0.4, 64.0))
        h3 = fleet_content_hash(str(root))
        assert h2 != h3
        assert fleet_content_hash(str(root)) == h3
        assert h3 == ref_agg.fleet_content_hash(str(root))

    def test_stage_scoped_include_invalidates_one_stage(self, tmp_path):
        root = tmp_path / "fleet"
        shared = tmp_path / "shared"
        shared.mkdir()
        _write_project(root, 5)
        (shared / "prod-extra.kdl").write_text(
            'service "a-0" { labels { tier "hot" } }\n')
        (root / ".fleetflow" / "flow.prod.kdl").write_text(
            'include "../../shared/prod-extra.kdl"\n')
        h1 = fleet_stage_hashes(str(root), ["prod", "dev"])
        (shared / "prod-extra.kdl").write_text(
            'service "a-0" { labels { tier "cold" } }\n')
        h2 = fleet_stage_hashes(str(root), ["prod", "dev"])
        assert h1["prod"] != h2["prod"]
        assert h1["dev"] == h2["dev"]

    def test_shared_transitive_include_sinks_into_every_reacher(
            self, tmp_path):
        root = tmp_path / "fleet"
        shared = tmp_path / "shared"
        shared.mkdir()
        _write_project(root, 6)
        (shared / "frag.kdl").write_text('include "deep.kdl"\n')
        (shared / "deep.kdl").write_text(
            'service "a-0" { labels { tier "hot" } }\n')
        cfg = root / ".fleetflow"
        (cfg / "flow.prod.kdl").write_text(
            'include "../../shared/frag.kdl"\n')
        (cfg / "flow.dev.kdl").write_text(
            'include "../../shared/frag.kdl"\n')
        h1 = fleet_stage_hashes(str(root), ["prod", "dev"])
        (shared / "deep.kdl").write_text(
            'service "a-0" { labels { tier "cold" } }\n')
        h2 = fleet_stage_hashes(str(root), ["prod", "dev"])
        assert h1["prod"] != h2["prod"]
        assert h1["dev"] != h2["dev"]

    def test_legacy_single_param_hash_still_works(self, tmp_path):
        _write_project(tmp_path, 3)
        reg = _registry(tmp_path)
        cache = FlowCache()
        versions = {str(tmp_path): "v1"}
        stages = {"f": ["prod"]}
        aggregate_fleets(reg, stages=stages, cache=cache,
                         content_hash=lambda p: versions[p])
        aggregate_fleets(reg, stages=stages, cache=cache,
                         content_hash=lambda p: versions[p])
        assert cache.hits >= 1 or cache.instance_hits >= 1
        versions[str(tmp_path)] = "v2"
        aggregate_fleets(reg, stages=stages, cache=cache,
                         content_hash=lambda p: versions[p])
        assert cache.misses >= 2


class TestInstanceDiskTier:
    def test_fresh_flowcache_hits_disk_instance(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_PARSE_CACHE", str(tmp_path / "pc"))
        proj = tmp_path / "proj"
        _write_project(proj, 7)
        reg = _registry(proj)
        stages = {"f": ["prod"]}
        pt1, ix1 = aggregate_fleets(reg, stages=stages, cache=FlowCache())
        cache2 = FlowCache()
        pt2, ix2 = aggregate_fleets(reg, stages=stages, cache=cache2)
        assert cache2.instance_hits == 1 and cache2.misses == 0
        assert tensor_diff(pt1, pt2) == []
        assert ix1.rows == ix2.rows
        b = proj / ".fleetflow" / "services" / "b.kdl"
        b.write_text(b.read_text() + "// changed\n")
        cache3 = FlowCache()
        aggregate_fleets(reg, stages=stages, cache=cache3)
        assert cache3.instance_hits == 0


# --------------------------------------------------------------------------
# the instance on the card's scheduler (its plain versions on the CPU)
# --------------------------------------------------------------------------

def test_card_places_and_warm_replaces_by_name(tmp_path, monkeypatch):
    """The aggregate placed by GpuSolverScheduler(device="cpu"), then a
    one-fleet edit re-aggregated and re-placed warm on the same stage key,
    seeded from the previous placement by row name: 0 violations both
    times, every row in exactly one node slice, and no row of an unedited
    fleet moved off a node the seed left without violation."""
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.sched import gpu
    from fleetflow_tpu_torch.solver.repair import verify
    # no routes: a route pins a whole 50-service stage onto one server
    path = write_registry(tmp_path, routes=())
    cache = FlowCache()
    stages = {f"t{i}": ["prod"] for i in range(F)}
    pt, ix = aggregate_fleets(parse_registry_file(path), stages=stages,
                              cache=cache)
    sched = GpuSolverScheduler(device="cpu")
    cold = sched.place(pt, stage="registry")
    assert cold.source == "gpu-anneal" and cold.feasible
    assert verify(pt, cold.raw)["total"] == 0
    chip_smoke.registry_slices_cover(np, ix, pt, cold.raw)

    write_fleet(tmp_path, 0, S_FLEET - 3)
    pt2, ix2 = aggregate_fleets(parse_registry_file(path), stages=stages,
                                cache=cache)
    assert cache.stats()["misses"] == F + 1
    seeds = []
    seeder = gpu.seed_by_name
    monkeypatch.setattr(gpu, "seed_by_name",
                        lambda *a: seeds.append(seeder(*a)) or seeds[-1])
    warm = sched.reschedule(pt2, stage="registry")
    res = sched.last_result
    assert len(seeds) == 1
    assert warm.source == "gpu-anneal" and warm.feasible
    assert verify(pt2, warm.raw)["total"] == 0
    moved = chip_smoke.registry_unforced_moves(np, pt2, ix2, cold, warm,
                                               edited={"t0"})
    assert moved["unforced"] == 0, moved
    assert moved["kept"] > 0.8 * pt2.S
    assert moved["edited"] > 0 and moved["spread_forced"] == 0
    # a warm solve from the seed: the fused pre-repair ran
    assert res.fused_prerepair and res.pre_repair_violations == 0


def plain_seed_by_name(pt, assignment, services, nodes):
    """seed_by_name's rule in plain loops, before its host repair: a row on
    the node its name had; each other row, in row order, on the
    least-utilised valid eligible node where it fits without sharing a
    conflict id, else the least-utilised valid eligible node, else the
    first valid node."""
    from fleetflow_tpu_torch.solver.repair import _unified_ids
    old = {s: nodes[int(j)] for s, j in zip(services, assignment)}
    seed = [pt.node_names.index(old[n]) if old.get(n) in pt.node_names
            else -1 for n in pt.service_names]
    ids = _unified_ids(pt)
    R = pt.demand.shape[1]
    for i in range(pt.S):
        if seed[i] >= 0:
            continue
        fit = anywhere = None
        for j in range(pt.N):
            if not (pt.eligible[i, j] and pt.node_valid[j]):
                continue
            on = [k for k in range(pt.S) if seed[k] == j]
            load = [sum(float(pt.demand[k, r]) for k in on) for r in range(R)]
            util = max(load[r] / max(float(pt.capacity[j, r]), 1e-6)
                       for r in range(R))
            fits = all(load[r] + float(pt.demand[i, r])
                       <= float(pt.capacity[j, r]) * (1 + 1e-6)
                       for r in range(R))
            clash = any(g >= 0 and g in ids[k] for k in on for g in ids[i])
            key = (util, j)
            if fits and not clash and (fit is None or key < fit):
                fit = key
            if anywhere is None or key < anywhere:
                anywhere = key
        pick = fit or anywhere
        seed[i] = pick[1] if pick else int(np.argmax(pt.node_valid))
    return np.array(seed, dtype=np.int32)


def old_lowering(pt, placed):
    """An earlier lowering of `pt`'s fleet and its assignment `placed`:
    rows 0-7 renumbered (reversed), row 8 on a node that has gone, rows
    9-11 absent, and the nodes listed in another order."""
    nodes = pt.node_names[::-1] + ["node-gone"]
    rows = list(range(7, -1, -1))
    services = [pt.service_names[i] for i in rows] + [pt.service_names[8]]
    assignment = np.array([nodes.index(pt.node_names[placed[i]])
                           for i in rows] + [len(nodes) - 1], np.int32)
    return assignment, services, nodes


def small_instance():
    from fleetflow_tpu_torch.lower.tensors import synthetic_problem
    from fleetflow_tpu_torch.solver.repair import verify
    pt = synthetic_problem(12, 4, seed=3, port_fraction=0.5)
    pt.capacity *= 1.6
    pt.node_valid[3] = False
    pt.eligible[10, :2] = False
    # rows 0 and 3 publish one host port, and so does the new row 11
    pt.port_ids[1] = -1
    pt.port_ids[11] = 0
    placed = np.array([0, 2, 0, 1, 1, 1, 2, 2, 1, 0, 2, 2], np.int32)
    assert verify(pt, placed)["total"] == 0
    return pt, placed


def test_seed_by_name():
    """Renamed, gone and new rows: the named rows keep their nodes by name
    (not by index), the others land where the plain rule puts them, and a
    seed without violations skips the host repair."""
    from fleetflow_tpu_torch.sched.gpu import seed_by_name
    from fleetflow_tpu_torch.solver.repair import verify
    pt, placed = small_instance()
    old = old_lowering(pt, placed)
    want = plain_seed_by_name(pt, *old)
    assert verify(pt, want)["total"] == 0
    seed = seed_by_name(pt, *old)
    assert seed.dtype == np.int32
    np.testing.assert_array_equal(seed, want)
    np.testing.assert_array_equal(seed[:8], placed[:8])
    assert pt.node_valid[seed].all() and pt.eligible[10, seed[10]]
    # node 1 is the least utilised but holds row 3's port: the conflict
    # rule decides row 11
    assert seed[11] == 2 and seed[3] == 1


def test_seed_by_name_falls_back_and_repairs():
    """A new row too big for every node goes to the least-utilised eligible
    one, a new row eligible nowhere to the first valid node, and the seed's
    violations go through the host repair."""
    from fleetflow_tpu_torch.sched.gpu import seed_by_name
    from fleetflow_tpu_torch.solver.repair import repair, verify
    pt, placed = small_instance()
    pt.demand[11] = pt.capacity.max(0) * 2
    pt.eligible[9] = False
    old = old_lowering(pt, placed)
    want = plain_seed_by_name(pt, *old)
    assert want[9] == 0 and verify(pt, want)["total"] > 0
    seed = seed_by_name(pt, *old)
    np.testing.assert_array_equal(
        seed, repair(pt, want).assignment.astype(np.int32))


def permuted(pt, order):
    """`pt` with its rows in `order`: the same fleet lowered again with
    its rows renumbered."""
    order = np.asarray(order)
    return dataclasses.replace(
        pt, service_names=[pt.service_names[i] for i in order],
        demand=pt.demand[order], dep_adj=pt.dep_adj[order][:, order],
        dep_depth=pt.dep_depth[order], port_ids=pt.port_ids[order],
        volume_ids=pt.volume_ids[order], anti_ids=pt.anti_ids[order],
        coloc_ids=pt.coloc_ids[order], eligible=pt.eligible[order],
        node_valid=pt.node_valid.copy(),
        preferred=None if pt.preferred is None else pt.preferred[order],
        replica_of=[pt.replica_of[i] for i in order] if pt.replica_of
        else [])


def test_scheduler_seeds_a_relowered_stage_by_name(monkeypatch):
    """A warm place on a stage key whose staging cannot take the new
    lowering seeds from the stage's last assignment: as it stands when the
    rows kept their names, by row name when they were renumbered (the
    index seed would put every row on another row's node)."""
    from fleetflow_tpu_torch.lower.tensors import synthetic_problem
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.sched import gpu
    pt = synthetic_problem(40, 8, seed=5)
    inits, named = [], []
    solve, seeder = gpu.solve, gpu.seed_by_name

    def spy_solve(*a, **k):
        inits.append(k.get("init_assignment"))
        return solve(*a, **k)
    monkeypatch.setattr(gpu, "solve", spy_solve)
    monkeypatch.setattr(gpu, "seed_by_name",
                        lambda *a: named.append(a) or seeder(*a))
    sched = GpuSolverScheduler(device="cpu", bucket=False)
    cold = sched.place(pt, stage="s")
    last = sched._slots[0].last_assignment
    same = permuted(pt, np.arange(pt.S))     # the same names, new tensors
    same.capacity = pt.capacity * 1.5
    sched.reschedule(same, stage="s")
    assert inits[-1] is last and not named
    order = np.arange(pt.S)[::-1]
    again = sched.last_result.assignment
    sched.reschedule(permuted(pt, order), stage="s")
    assert len(named) == 1
    np.testing.assert_array_equal(inits[-1], again[order])
    assert cold.feasible


def test_unforced_moves_under_a_spread_rule():
    """registry_unforced_moves forces, for a spread violation, only the
    rows of a zone above the emptiest one: a row of the emptiest zone that
    moves is an unforced move."""
    import types

    from fleetflow_tpu_torch.lower.tensors import synthetic_problem
    from fleetflow_tpu_torch.sched.base import Placement
    pt = synthetic_problem(9, 3, seed=0)
    pt.capacity[:] = 1e9
    for arr in (pt.port_ids, pt.volume_ids, pt.anti_ids):
        arr[:] = -1
    pt.eligible[:] = True
    pt.node_topology = np.array([0, 1, 2], np.int32)
    pt.max_skew = 1
    index = types.SimpleNamespace(rows=[("f", "prod", n)
                                        for n in pt.service_names])
    at = np.array([0, 0, 0, 0, 0, 1, 1, 1, 2])

    def placement(raw):
        return Placement(assignment={n: pt.node_names[j] for n, j
                                     in zip(pt.service_names, raw)},
                         levels=[], feasible=True, raw=np.asarray(raw))
    before = placement(at)
    moved_low = at.copy()
    moved_low[8] = 0
    got = chip_smoke.registry_unforced_moves(np, pt, index, before,
                                             placement(moved_low), set())
    assert got["spread_forced"] == 8 and got["unforced"] == 1, got
    moved_high = at.copy()
    moved_high[0] = 2
    got = chip_smoke.registry_unforced_moves(np, pt, index, before,
                                             placement(moved_high), set())
    assert got["unforced"] == 0 and got["moved"] == 1, got


def test_registry_phase_rehearsal(tmp_path, monkeypatch, capsys):
    """chip_smoke's [registry] phase at a small size on the CPU: 8 fleets
    of 40 services as project directories, 30 servers, a fork pool of 2,
    the cold place, the one-fleet edit (one miss, seven hits) and the warm
    re-place, every check of the phase (the plain versions launch no
    kernel to count)."""
    import json

    import torch

    from fleetflow_tpu_torch import _ext
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))
    out = chip_smoke.run_registry_phase(
        torch, np, _ext, REGISTRY, "cpu", "card", device="cpu",
        root=str(tmp_path / "registry"), services=40, nodes=30, trim=3,
        workers=2, expect=())
    assert out["cache"]["misses"] == F + 1 and out["cache"]["hits"] == F - 1
    assert out["rows"][1] == 30 and out["unforced"] == 0
    assert out["pool_load_ms"] > 0 and out["lower_ms"] > 0
    rows = [json.loads(ln.split(" ", 1)[1])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[registry] {")]
    assert [r.get("step") for r in rows[:2]] == ["cold", "warm"]
    assert rows[0]["misses"] == F and rows[1]["misses"] == 1
    assert rows[1]["hits"] == F - 1 and rows[0]["gauge_lower_ms"] > 0
    assert rows[-1]["budget_s"] == chip_smoke.REGISTRY_BUDGET_S


def test_reference_fleetgen_is_the_ports():
    assert ref_fleetgen.generate_fleet_kdl("t3", 20, seed=103) == \
        fleetgen.generate_fleet_kdl("t3", 20, seed=103)


def test_a_device_fault_fails_the_registry_phase(tmp_path, monkeypatch):
    """No fallback hides the card: a kernel fault in the aggregate's
    placement reaches the phase's caller."""
    import torch

    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.core.errors import KernelError
    from fleetflow_tpu_torch.sched import gpu

    def boom(*a, **k):
        raise KernelError("k4_greedy: an illegal memory access")
    monkeypatch.setattr(gpu, "solve", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(KernelError, match="k4_greedy"):
        chip_smoke.run_registry_phase(
            torch, np, _ext, REGISTRY, "cpu", "card", device="cpu",
            root=str(tmp_path / "registry"), services=10, nodes=8,
            trim=1, workers=0, expect=())
