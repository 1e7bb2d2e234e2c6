"""The port's discovery and load pipeline (fleetflow_tpu_torch.core.loader,
.discovery) against the reference's, on the reference's loader scenarios
and the repo's examples.

Each scenario writes one project and loads it with both packages'
``load_project_from_root_with_stage``: the Flows serialize to the same
dict (or both raise the same error), the discovered file sets agree, and
the debug collector holds the same artifacts. The loader's fork pool
(FLEET_PARSE_WORKERS) parses a multi-file project to the same Flow as the
serial path, and the parse phase lands in the port's
``fleet_frontend_phase_ms`` gauge.
"""

import os
import shutil

import pytest

from fleetflow_tpu import core as ref_core
from fleetflow_tpu.core import serialize as ref_ser
from fleetflow_tpu_torch import core as port_core
from fleetflow_tpu_torch.core import model as port_model
from fleetflow_tpu_torch.core import parsecache as port_pc
from fleetflow_tpu_torch.core import serialize as port_ser
from fleetflow_tpu_torch.lower.fleetgen import (generate_fleet_kdl,
                                                generate_servers_kdl)
from torch_frontend_cases import EXAMPLES, run

BASE = '''
project "testproj"

service "postgres" {
    image "postgres"
    version "16"
    ports { port host=11432 container=5432 }
    env { POSTGRES_USER "flowuser" }
    resources { cpu 0.5; memory 256 }
}

service "redis" {
    image "redis"
    version "7"
    ports { port host=11379 container=6379 }
}

service "app" {
    image "app"
    depends_on "postgres" "redis"
}

stage "local" {
    service "postgres"
    service "redis"
    service "app"
}
'''

# (files under .fleetflow/, files at the root, stage, environ)
SCENARIOS = {
    "basic": ({"fleet.kdl": BASE}, {}, None, {}),
    "template-vars": ({"fleet.kdl": 'project "p"\nvariables { PG_VERSION '
                       '"16" }\nservice "db" { image "postgres:{{ '
                       'PG_VERSION }}" }\nstage "local" { service "db" }'},
                      {}, None, {}),
    "dotenv-chain": ({"fleet.kdl": 'project "p"\nservice "db" { image '
                      '"postgres:{{ V }}" }'},
                     {".env": "V=from-env\n",
                      ".env.external": "V=from-external\n"}, None, {}),
    "dotenv-stage": ({"fleet.kdl": 'project "p"\nservice "db" { image '
                      '"postgres:{{ V }}" }'},
                     {".env": "V=from-env\n",
                      ".env.external": "V=from-external\n",
                      ".env.prod": "V=from-stage-env\n"}, "prod", {}),
    "allowlisted-env": ({"fleet.kdl": 'project "p"\nservice "db" { image '
                         '"postgres:{{ FLEET_V }}" }'},
                        {".env": "FLEET_V=dotenv\n"}, None,
                        {"FLEET_V": "process-env", "HOME_X": "no"}),
    "stage-vars": ({"fleet.kdl": 'project "p"\nvariables { V "top" }\n'
                    'service "db" { image "postgres:{{ V }}" }\n'
                    'stage "dev" {\n service "db"\n variables { V "stage" }'
                    '\n}'}, {}, "dev", {}),
    "stage-vars-unselected": ({"fleet.kdl": 'project "p"\nvariables { V '
                               '"top" }\nservice "db" { image "pg:{{ V }}" '
                               '}\nstage "dev" { variables { V "stage" } }'},
                              {}, None, {}),
    "local-override": ({"fleet.kdl": 'project "p"\nservice "db" { image '
                        '"a"; version "1" }',
                        "flow.local.kdl": 'service "db" { version '
                        '"2-local" }'}, {}, None, {}),
    "stage-override-order": ({"fleet.kdl": 'project "p"\nservice "db" { '
                              'version "1" }',
                              "flow.prod.kdl": 'service "db" { version '
                              '"prod" }',
                              "flow.local.kdl": 'service "db" { version '
                              '"local" }'}, {}, "prod", {}),
    "services-dir": ({"fleet.kdl": BASE,
                      "services/db.kdl": 'service "postgres" { env { '
                      'EXTRA "1" } }',
                      "services/sub/extra.kdl": 'service "db3" { }'},
                     {}, None, {}),
    "project-root": ({"fleet.kdl": 'project "p"\nservice "db" { volumes { '
                      'volume "{{ PROJECT_ROOT }}/data" "/data" } }'},
                     {}, None, {}),
    "variables-dir": ({"fleet.kdl": 'project "p"\nservice "db" { image '
                       '"pg:{{ COMMON }}" }',
                       "variables/common.kdl": 'variables { COMMON '
                       '"shared" }'}, {}, None, {}),
    "full-file-set": ({"fleet.kdl": BASE,
                       "cloud.kdl": 'provider "x" { zone "z" }',
                       "services/db.kdl": 'service "db2" { }',
                       "stages/prod.kdl": 'stage "prod" { service "db2" }',
                       "variables/common.kdl": 'variables { V "1" }',
                       "flow.prod.kdl": 'project "override"',
                       "flow.local.kdl": 'variables { L "local" }'},
                      {}, "prod", {}),
    "undefined-variable": ({"fleet.kdl": 'service "a" { image "{{ NOPE '
                            '}}" }'}, {}, None, {}),
    "brace-across-files": ({"cloud.kdl": 'server "s" {\n',
                            "fleet.kdl": '  capacity { cpu 2 }\n}\n'
                            'service "a" { }'}, {}, None, {}),
    "parse-error": ({"fleet.kdl": 'service "a" {\n  image "x\n'}, {}, None,
                    {}),
    "no-main-file": ({"cloud.kdl": 'provider "x" { }'}, {}, None, {}),
}


def write_project(root, files, root_files):
    cfg = root / ".fleetflow"
    for rel, text in files.items():
        p = cfg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    cfg.mkdir(exist_ok=True)
    for rel, text in root_files.items():
        (root / rel).write_text(text)
    return str(root)


def load_both(root, stage=None, **kw):
    ref = run(ref_core.load_project_from_root_with_stage, root, stage, **kw)
    port = run(port_core.load_project_from_root_with_stage, root, stage,
               **kw)
    if ref[0] == "ok":
        ref = ("ok", ref_ser.flow_to_dict(ref[1]))
    if port[0] == "ok":
        assert isinstance(port[1], port_model.Flow)
        port = ("ok", port_ser.flow_to_dict(port[1]))
    return ref, port


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_load_parity(name, tmp_path):
    files, root_files, stage, environ = SCENARIOS[name]
    root = write_project(tmp_path, files, root_files)
    ref, port = load_both(root, stage, environ=environ)
    assert port == ref
    # the discovered file set, in its fixed concatenation order
    ref_d = ref_core.discover_files_with_stage(root, stage)
    port_d = port_core.discover_files_with_stage(root, stage)
    assert port_d.all_files() == ref_d.all_files()
    assert vars(port_d) == vars(ref_d)


def test_debug_collector_parity(tmp_path):
    files, root_files, stage, environ = SCENARIOS["full-file-set"]
    root = write_project(tmp_path, files, root_files)
    ref_dbg, port_dbg = ref_core.LoadDebug(), port_core.LoadDebug()
    ref_core.load_project_from_root_with_stage(root, stage, environ=environ,
                                               debug=ref_dbg)
    port_core.load_project_from_root_with_stage(root, stage, environ=environ,
                                                debug=port_dbg)
    assert vars(port_dbg) == vars(ref_dbg)
    assert port_dbg.files and "PROJECT_ROOT" in port_dbg.variables


def test_find_project_root_parity(tmp_path, monkeypatch):
    root = write_project(tmp_path / "proj", {"fleet.kdl": BASE}, {})
    nested = tmp_path / "proj" / "src" / "deep"
    nested.mkdir(parents=True)
    assert port_core.find_project_root(str(nested)) == \
        ref_core.find_project_root(str(nested)) == os.path.realpath(root)
    lone = tmp_path / "lone"
    lone.mkdir()
    assert run(port_core.find_project_root, str(lone)) == \
        run(ref_core.find_project_root, str(lone))
    with pytest.raises(port_core.ConfigNotFound):
        port_core.find_project_root(str(lone))
    monkeypatch.setenv("FLEET_PROJECT_ROOT", root)
    assert port_core.find_project_root(str(lone)) == os.path.realpath(root)
    monkeypatch.setenv("FLEET_PROJECT_ROOT", str(lone))
    assert run(port_core.find_project_root, str(lone)) == \
        run(ref_core.find_project_root, str(lone))


def example_roots(tmp_path):
    """(name, project root, stages) of each example; plan-simulate's flow
    file is copied into a project of its own."""
    out = []
    for ex in sorted(os.listdir(EXAMPLES)):
        src = EXAMPLES / ex
        if not (src / ".fleetflow").is_dir():
            (tmp_path / ex / ".fleetflow").mkdir(parents=True)
            shutil.copy(src / "flow.kdl",
                        tmp_path / ex / ".fleetflow" / "fleet.kdl")
            src = tmp_path / ex
        nodes = port_core.parse_document(
            (src / ".fleetflow" / "fleet.kdl").read_text())
        out.append((ex, str(src),
                    [n.args[0] for n in nodes if n.name == "stage"]))
    return out


def test_examples_load_parity(tmp_path):
    roots = example_roots(tmp_path)
    assert {ex for ex, _, _ in roots} >= {"hello-world", "production",
                                          "plan-simulate"}
    n = 0
    for _ex, root, stages in roots:
        for stage in stages:
            ref, port = load_both(root, stage, environ={})
            assert port[0] == "ok" and port == ref, (root, stage)
            n += 1
    assert n >= 5


def _big_project(tmp_path, n_services=300, n_nodes=30):
    """A project of three files above the parse cache's threshold, so the
    loader's pool takes them."""
    cfg = tmp_path / ".fleetflow"
    (cfg / "services").mkdir(parents=True)
    (cfg / "cloud.kdl").write_text(generate_servers_kdl(n_nodes, seed=7))
    (cfg / "fleet.kdl").write_text(generate_fleet_kdl(
        "t0", n_services, seed=100, n_nodes_hint=n_nodes))
    (cfg / "services" / "extra.kdl").write_text(generate_fleet_kdl(
        "t1", n_services // 2, seed=101, n_nodes_hint=n_nodes,
        port_base=20_000).replace('stage "prod"', 'stage "extra"'))
    return str(tmp_path)


def test_parse_pool_parity(tmp_path, monkeypatch):
    """FLEET_PARSE_WORKERS=2: the fork pool parses the three files (its
    workers hand back port fragments, adopted into the memory tier) to the
    Flow of the serial load and of the reference; the parse phase is in
    the port's gauge."""
    import concurrent.futures as cf
    root = _big_project(tmp_path)
    serial = load_both(root, "prod", environ={})
    port_core.parsecache.parse_cache_clear()
    port_pc.M_FRONTEND_PHASE_MS.set(-1.0, phase="parse")
    pools, adopted = [], []
    real_pool, real_adopt = cf.ProcessPoolExecutor, port_pc.ParseCache.adopt

    class Recording(real_pool):
        def __init__(self, *a, **kw):
            pools.append(kw.get("max_workers"))
            super().__init__(*a, **kw)

    def adopt(self, key, frag):
        adopted.append(type(frag))
        return real_adopt(self, key, frag)
    monkeypatch.setattr(cf, "ProcessPoolExecutor", Recording)
    monkeypatch.setattr(port_pc.ParseCache, "adopt", adopt)
    monkeypatch.setenv("FLEET_PARSE_WORKERS", "2")
    monkeypatch.setenv("FLEET_PARSE_CACHE_MEM", "0")
    pooled = load_both(root, "prod", environ={})
    assert pooled == serial and pooled[0] == pooled[1]
    assert pools == [2, 2]          # the reference's pool, then the port's
    assert adopted == [port_model.Flow] * 3
    assert port_pc.M_FRONTEND_PHASE_MS.value(phase="parse") >= 0.0


def test_pool_workers_only_parse(tmp_path, monkeypatch):
    """The pool's job parses and returns a port fragment; run in a forked
    child it needs nothing but the front end."""
    import multiprocessing as mp
    from fleetflow_tpu_torch.core import loader
    text = generate_fleet_kdl("t0", 60, seed=1, n_nodes_hint=10)
    monkeypatch.setenv("FLEET_PARSE_CACHE_MEM", "0")
    with mp.get_context("fork").Pool(1, initializer=loader._pool_init) as p:
        frag = p.apply(loader._fragment_job, ((text, False, 0),))
    assert isinstance(frag, port_model.Flow)
    assert port_ser.flow_to_dict(frag) == port_ser.flow_to_dict(
        port_core.parse_kdl_string(text, cache=False))
