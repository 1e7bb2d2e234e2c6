"""The port's daemon (fleetflow_tpu_torch.daemon: the config, the pid
file, the REST surface, the health checker and the daemonized start)
against the reference's, on the CPU.

- tests/test_daemon.py on the port: the config search chain and its keys,
  the pid file, the health checker's transitions and churn, and
  ``TestDaemonizedStart`` as subprocesses of
  ``python -m fleetflow_tpu_torch.daemon`` with ``solver-device "cpu"``;
- the solver keys: ``use_gpu_solver`` on by default, the reference's
  ``tpu-solver``/``use-tpu-solver`` and ``gpu-solver`` setting it,
  ``solver-device`` naming the card scheduler's device; every other field
  equal to the reference's config on the same KDL (the production example
  included);
- the REST surface (``WebServer``) over each package's control plane (the
  reference, the port's host path and the port's card scheduler on the
  CPU): test_daemon.py's TestWebServer, TestDashboard and TestLogTopics,
  the dashboard's HTML byte-equal, and the reference tests that waited for
  the port's web surface (test_cp.py's
  ``test_web_redeploy_replays_last_deployment``, test_auth_idp.py's
  TestWebRoutePermissions, the REST half of TestCrossSurfaceVocabulary and
  TestBrowserDeviceLogin, test_replication.py's
  ``test_standby_web_surface_refuses_writes``);
- ``GET /metrics`` of the port's daemon against
  ``tests/goldens/metrics_exposition.txt``, with the exceptions that
  tests/test_torch_metrics.py lists;
- no fallback: without CUDA, ``Daemon.start``, ``fleet cp daemon run`` and
  the daemonized ``start`` fail with the DeviceUnavailable message and
  leave nothing listening.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
from http.server import HTTPServer

import pytest

from test_daemon import http_get, http_get_raw, http_post
from test_torch_metrics import HELP_EXCEPTIONS, NOT_REGISTERED
from torch_wire_kit import ALL, PORT, REF, connect, ids, run, start_cp

from fleetflow_tpu_torch.core.errors import DeviceUnavailable
from fleetflow_tpu_torch.daemon import Daemon, DaemonConfig
from fleetflow_tpu_torch.daemon.config import load_daemon_config
from fleetflow_tpu_torch.daemon.health import HealthChecker
from fleetflow_tpu_torch.daemon.pidfile import PidFile, PidStatus

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "metrics_exposition.txt"
NO_CUDA = "needs a CUDA device"


@pytest.fixture(params=ALL, ids=ids(ALL))
def P(request):
    return request.param


def web_mod(P):
    return importlib.import_module(f"{P.root}.daemon.web")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------
# the config
# --------------------------------------------------------------------------

def _fields(cfg) -> dict:
    """The config's fields but the solver's (which the port renames)."""
    from dataclasses import asdict
    d = asdict(cfg)
    for k in ("use_tpu_solver", "use_gpu_solver", "device"):
        d.pop(k, None)
    return d


CONFIG_TEXTS = {
    "full": '''
pid-file "/tmp/ff.pid"
log-file "/tmp/ff.log"
listen host="0.0.0.0" port=9510
web enabled=#true host="0.0.0.0" port=8080
db "/var/lib/ff/cp.json"
auth "jwks" jwks="https://idp.test/jwks.json" issuer="https://idp.test/" \\
    audience="fleet-api" client-id="dash"
tls-dir "/var/lib/ff/ca"
health-interval 15
health-tailscale #true
heartbeat-stale 45
autoscale-interval 120
tpu-solver #true
replication standby-of="cp-a:4510" token="t" ping=1 lease=4 grace=2
self-heal #true lease=45 grace=10 interval=2
admission #true queue=512 batch=32 shed-age=30
slo placement-p99-ms=50 heal-p99-s=30
''',
    "positional": 'listen "0.0.0.0" 4517\nweb "127.0.0.1" 9090\ndb "memory"\n',
    "bare_false": 'tpu-solver false\nhealth-tailscale false\n'
                  'web enabled=false\nself-heal false\nadmission false\n',
    "empty": "",
}


class TestDaemonConfig:
    def test_defaults_when_no_file(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        cfg = load_daemon_config()
        assert cfg.listen_port == 4510 and cfg.web_port == 32080
        assert cfg.source is None and "~" not in cfg.pid_file
        # the port's control plane places on the card by default
        assert cfg.use_gpu_solver is True and cfg.device is None

    @pytest.mark.parametrize("name", sorted(CONFIG_TEXTS))
    def test_fields_equal_the_reference(self, name, tmp_path):
        from fleetflow_tpu.daemon.config import \
            load_daemon_config as ref_load
        p = tmp_path / "fleetflowd.kdl"
        p.write_text(CONFIG_TEXTS[name])
        ref, port = ref_load(str(p)), load_daemon_config(str(p))
        assert _fields(port) == _fields(ref)
        if name in ("full", "bare_false"):
            assert port.use_gpu_solver is ref.use_tpu_solver

    def test_production_example_loads_unchanged(self):
        from fleetflow_tpu.daemon.config import \
            load_daemon_config as ref_load
        path = str(REPO / "examples" / "production" / "fleetflowd.kdl")
        ref, port = ref_load(path), load_daemon_config(path)
        assert _fields(port) == _fields(ref)
        assert ref.use_tpu_solver is True and port.use_gpu_solver is True
        assert port.device is None

    @pytest.mark.parametrize("key", ["tpu-solver", "use-tpu-solver",
                                     "gpu-solver"])
    def test_solver_keys(self, key, tmp_path):
        p = tmp_path / "fleetflowd.kdl"
        for text, want in (("#false", False), ("false", False),
                           ("#true", True), ("true", True)):
            p.write_text(f"{key} {text}\n")
            assert load_daemon_config(str(p)).use_gpu_solver is want

    def test_solver_device(self, tmp_path):
        p = tmp_path / "fleetflowd.kdl"
        p.write_text('solver-device "cpu"\n')
        cfg = load_daemon_config(str(p))
        assert cfg.device == "cpu" and cfg.use_gpu_solver is True

    def test_explicit_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_daemon_config(str(tmp_path / "nope.kdl"))

    def test_self_heal_and_admission_knobs(self, tmp_path):
        p = tmp_path / "fleetflowd.kdl"
        p.write_text('self-heal #true lease=45 grace=10 interval=2\n'
                     'admission #true queue=512 batch=32 shed-age=30\n')
        cfg = load_daemon_config(str(p))
        assert (cfg.self_heal, cfg.lease_s, cfg.suspect_grace_s,
                cfg.heal_interval_s) == (True, 45.0, 10.0, 2.0)
        assert (cfg.admission, cfg.admission_queue, cfg.admission_batch,
                cfg.admission_shed_age_s) == (True, 512, 32, 30.0)
        p.write_text('listen "127.0.0.1" 4510\n')
        cfg = load_daemon_config(str(p))
        assert cfg.self_heal is True and cfg.lease_s == 90.0
        assert cfg.admission is True and cfg.admission_queue == 4096

    def test_bad_slo_fails_at_load(self, tmp_path):
        p = tmp_path / "fleetflowd.kdl"
        p.write_text("slo bogus-p99-ms=5\n")
        with pytest.raises(Exception):
            load_daemon_config(str(p))


class TestPidFile:
    def test_lifecycle(self, tmp_path):
        pf = PidFile(str(tmp_path / "d.pid"))
        assert pf.status()[0] is PidStatus.STOPPED
        pf.acquire()
        st, pid = pf.status()
        assert st is PidStatus.RUNNING and pid == os.getpid()
        with pytest.raises(RuntimeError, match="already running"):
            pf.acquire()
        pf.release()
        assert pf.status()[0] is PidStatus.STOPPED

    def test_stale_recovery(self, tmp_path):
        pf = PidFile(str(tmp_path / "d.pid"))
        pf.path.write_text("999999999")
        assert pf.status()[0] is PidStatus.STALE
        pf.acquire()
        assert pf.status()[0] is PidStatus.RUNNING
        pf.release()

    def test_across_packages(self, tmp_path):
        from fleetflow_tpu.daemon.pidfile import PidFile as RefPidFile
        path = str(tmp_path / "d.pid")
        PidFile(path).acquire()
        st, pid = RefPidFile(path).status()
        assert (st.value, pid) == ("running", os.getpid())
        with pytest.raises(RuntimeError, match="already running"):
            RefPidFile(path).acquire()
        PidFile(path).release()
        assert RefPidFile(path).status()[0].value == "stopped"


# --------------------------------------------------------------------------
# the REST surface, over each package's control plane
# --------------------------------------------------------------------------

class TestWebServer:
    def test_public_and_protected_routes(self, P):
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, body = await http_get(host, port, "/api/health")
            assert st == 200 and body["status"] == "ok"
            assert "store" not in body
            st, body = await http_get(host, port, "/api/auth/config")
            assert body["kind"] == "token"
            st, _ = await http_get(host, port, "/api/overview")
            assert st == 401
            token = handle.state.auth.issue("op@x", ["admin:all"])
            st, body = await http_get(host, port, "/api/overview", token)
            assert st == 200 and body["servers"] == 0
            assert body["store"] == {"entries": 0, "bytes": 0,
                                     "compactions": 0}
            st, _ = await http_get(host, port, "/api/nope", token)
            assert st == 404
            await web.stop()
            await handle.stop()
        run(go())

    def test_crud_routes(self, P):
        async def go():
            handle = await start_cp(P)
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, _ = await http_post(host, port, "/api/tenants",
                                    {"name": "acme"})
            assert st == 201
            st, body = await http_post(host, port, "/api/tenants/acme/users",
                                       {"email": "a@b.c", "role": "admin"})
            assert st == 201 and body["user"]["role"] == "admin"
            st, body = await http_get(host, port, "/api/tenants/acme/users")
            assert len(body["users"]) == 1
            st, _ = await http_post(host, port, "/api/dns",
                                    {"zone": "z.com", "name": "a",
                                     "content": "1.1.1.1"})
            assert st == 201
            st, body = await http_get(host, port, "/api/dns?zone=z.com")
            assert len(body["records"]) == 1
            handle.state.store.register_server("n1")
            st, body = await http_post(host, port, "/api/servers/n1/cordon")
            assert body["scheduling_state"] == "cordoned"
            st, body = await http_get(host, port, "/api/servers")
            assert body["servers"][0]["scheduling_state"] == "cordoned"
            await web.stop()
            await handle.stop()
        run(go())


class TestDashboard:
    def test_html_equals_the_reference(self):
        from fleetflow_tpu.daemon import web as ref_web
        from fleetflow_tpu_torch.daemon import web as port_web
        assert port_web._DASHBOARD_HTML == ref_web._DASHBOARD_HTML

    def test_dashboard_served(self, P):
        async def go():
            handle = await start_cp(P)
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, html = await http_get_raw(host, port, "/")
            assert st == 200
            for view in ("overview", "servers", "stages", "deployments",
                         "alerts", "placement", "agents", "pools",
                         "containers", "tenants", "costs", "dns",
                         "volumes", "builds"):
                assert f"async {view}(" in html, view
            assert "async stage(" in html and "async deployment(" in html
            assert "function esc(" in html and "onclick=" not in html
            assert "<title>fleetflow-tpu</title>" in html
            await web.stop()
            await handle.stop()
        run(go())

    def test_spa_api_routes_serve_live_state(self, P):
        async def go():
            handle = await start_cp(P)
            db = handle.state.store
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            M = P.models
            db.register_server("n1")
            db.create("projects", M.Project(tenant="default", name="web"))
            stage = db.create("stages", M.StageRecord(
                project="web", name="live", servers=["n1"]))
            db.create("alerts", M.Alert(server="n1", kind="unhealthy",
                                        message="container flapping"))
            db.create("volumes", M.VolumeRecord(tenant="default",
                                                server="n1", name="pgdata"))
            db.create("build_jobs", M.BuildJob(repo="git@x:app",
                                               image_tag="app:1",
                                               status="running"))
            st, body = await http_get(host, port, "/api/alerts")
            assert st == 200 and len(body["alerts"]) == 1
            st, body = await http_get(host, port, "/api/volumes")
            assert body["volumes"][0]["name"] == "pgdata"
            st, body = await http_get(host, port, "/api/builds")
            assert body["jobs"][0]["image_tag"] == "app:1"
            st, body = await http_get(host, port, "/api/agents")
            assert body["agents"] == []
            st, body = await http_get(host, port, "/api/placement")
            assert body["stages"] == {}
            st, body = await http_get(
                host, port,
                "/api/placement/explain?stage=shop/live&service=api")
            assert st == 404 and "no retained placement" in body["error"]
            parser = importlib.import_module(f"{P.root}.core.parser")
            db.update("servers", db.server_by_slug("n1").id,
                      status="online",
                      capacity=M.ServerCapacity(cpu=4, memory=4096,
                                                disk=999))
            pflow = parser.parse_kdl_string(
                'project "shop"\n'
                'server "n1" { capacity { cpu 4; memory 4096; disk 999 } }\n'
                'service "api" { image "x"; '
                'resources { cpu 1; memory 64; disk 1 } }\n'
                'stage "live" { service "api"; servers "n1" }')
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: handle.state.placement.solve_stage(
                    pflow, "live"))
            st, body = await http_get(
                host, port,
                "/api/placement/explain?stage=shop/live&service=api")
            assert st == 200 and body["chosen"]["node"] == "n1"
            assert body["chosen"]["feasible"] and body["chosen_rank"] == 1
            db.create("worker_pools", M.WorkerPool(name="builders",
                                                   min_servers=1))
            st, body = await http_get(host, port, "/api/pools")
            assert body["pools"][0]["name"] == "builders"
            st, body = await http_get(host, port,
                                      f"/api/stages/{stage.id}/status")
            assert st == 200 and body["stage"]["name"] == "live"
            db.create("cost_entries", M.CostEntry(
                tenant="default", server="n1", provider="sakura",
                month="2026-07", amount=42.5))
            db.create("cost_entries", M.CostEntry(
                tenant="acme", server="n1", provider="aws",
                month="2026-06", amount=10.0))
            st, body = await http_get(host, port,
                                      "/api/costs/summary?month=2026-07")
            assert body["totals"] == [{"tenant": "default", "total": 42.5}]
            st, body = await http_get(host, port, "/api/costs/summary")
            assert {t["tenant"]: t["total"] for t in body["totals"]} == \
                {"default": 42.5, "acme": 10.0}
            await web.stop()
            await handle.stop()
        run(go())


class TestLogTopics:
    def test_topics_and_lines_over_rest(self, P):
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            lr = P.log_router
            handle.state.log_router.publish(lr.LogEntry(
                topic=lr.topic_for("n1", "deploy/live"),
                line="started web", level="info"))
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            tok = handle.state.auth.issue("r@x", ["read:container"])
            st, doc = await http_get(host, port, "/api/logs", tok)
            assert st == 200 and doc["topics"] == ["logs/n1/deploy/live"]
            st, doc = await http_get(host, port,
                                     "/api/logs/n1/deploy%2Flive", tok)
            assert st == 200 and doc["lines"][0]["line"] == "started web"
            other = handle.state.auth.issue("o@x", ["read:health"])
            st, _ = await http_get(host, port, "/api/logs", other)
            assert st == 403
            await web.stop()
            await handle.stop()
        run(go())


class TestWaitingReferenceTests:
    """The reference tests that waited for the port's web surface."""

    def test_web_redeploy_replays_last_deployment(self, P, project):
        # test_cp.py TestDeployExecute
        from torch_wire_kit import load_flow

        async def go():
            root, _ = project
            flow = load_flow(P, root)
            handle = await start_cp(P)
            conn, _ = await connect(P, handle)
            req = P.runtime.DeployRequest(flow=flow, stage_name="local")
            out = await conn.request("deploy", "execute",
                                     {"request": req.to_dict(),
                                      "tenant": "acme"})
            sid = out["deployment"]["stage"]
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, body = await http_post(host, port,
                                       f"/api/stages/{sid}/redeploy")
            assert st == 200, body
            assert body["deployment"]["status"] == "succeeded"
            hist = await conn.request("deploy", "history", {})
            assert len(hist["deployments"]) == 2
            st, _ = await http_post(host, port, "/api/stages/nope/redeploy")
            assert st == 404
            await web.stop()
            await conn.close()
            await handle.stop()
        run(go())

    def test_read_only_token_cannot_mutate(self, P):
        # test_auth_idp.py TestWebRoutePermissions
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            reader = handle.state.auth.issue("ro@x", ["read:*"])
            writer = handle.state.auth.issue("rw@x", ["read:*", "write:*"])
            st, _ = await http_get(host, port, "/api/overview", reader)
            assert st == 200
            st, body = await http_post(host, port, "/api/tenants",
                                       {"name": "acme"}, reader)
            assert st == 403 and "write:tenant" in body["error"]
            st, _ = await http_post(host, port, "/api/tenants",
                                    {"name": "acme"}, writer)
            assert st in (200, 201)
            narrow = handle.state.auth.issue("n@x", ["read:health"])
            st, _ = await http_get(host, port, "/api/overview", narrow)
            assert st == 200
            st, _ = await http_get(host, port, "/api/servers", narrow)
            assert st == 403
            stale = handle.state.auth.issue("o@x", ["read:overview"])
            st, _ = await http_get(host, port, "/api/overview", stale)
            assert st == 403
            await web.stop()
            await handle.stop()
        run(go())

    def test_same_grant_both_surfaces(self, P):
        # test_auth_idp.py TestCrossSurfaceVocabulary, the REST half
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            tok = handle.state.auth.issue("s@x", ["read:server"])
            st, _ = await http_get(host, port, "/api/servers", tok)
            assert st == 200
            conn, task = await connect(P, handle, token=tok)
            assert "servers" in await conn.request("server", "list")
            await conn.close()
            task.cancel()
            await web.stop()
            await handle.stop()
        run(go())

    def test_device_endpoints_404_without_idp(self, P):
        # test_auth_idp.py TestBrowserDeviceLogin
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, cfg = await http_get(host, port, "/api/auth/config")
            assert st == 200 and cfg["device"] is False
            st, _ = await http_post(host, port, "/api/auth/device/start")
            assert st == 404
            await web.stop()
            await handle.stop()
        run(go())

    def test_spa_device_login_end_to_end(self, P, tmp_path):
        # test_auth_idp.py TestBrowserDeviceLogin, against the reference's
        # mock IdP
        pytest.importorskip("cryptography")
        from test_auth_idp import MockIdpHandler
        from test_torch_auth import RsaIdp
        idp = RsaIdp()
        srv = HTTPServer(("127.0.0.1", 0), MockIdpHandler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        mock_idp = f"http://127.0.0.1:{srv.server_port}"
        MockIdpHandler.deny = False
        MockIdpHandler.token_value = idp.token(
            issuer=mock_idp, permissions=["read:health"])
        path = tmp_path / "jwks.json"
        path.write_text(json.dumps(idp.jwks()))

        async def go():
            handle = await start_cp(P, auth_kind="jwks",
                                    auth_jwks=str(path),
                                    auth_issuer=mock_idp,
                                    auth_client_id="dash")
            web = web_mod(P).WebServer(handle.state)
            host, port = await web.start()
            st, cfg = await http_get(host, port, "/api/auth/config")
            assert st == 200 and cfg == {"kind": "jwks", "device": True}
            st, _ = await http_get(host, port, "/api/overview")
            assert st == 401
            st, d = await http_post(host, port, "/api/auth/device/start")
            assert st == 200 and d["user_code"] == "ABCD-EFGH"
            statuses, token = [], None
            for _ in range(6):
                st, p = await http_post(host, port, "/api/auth/device/poll",
                                        {"device_code": d["device_code"]})
                assert st == 200
                statuses.append(p["status"])
                if p["status"] == "ok":
                    token = p["access_token"]
                    break
            assert statuses[:2] == ["pending", "pending"] and token
            st, me = await http_get(host, port, "/api/me", token)
            assert st == 200 and me["auth"] == "jwks"
            st, _ = await http_get(host, port, "/api/overview", token)
            assert st == 200
            st, _ = await http_get(host, port, "/api/servers", token)
            assert st == 403
            saw_429 = False
            for _ in range(6):
                st, _ = await http_post(host, port,
                                        "/api/auth/device/start")
                if st == 429:
                    saw_429 = True
                    break
            assert saw_429
            await web.stop()
            await handle.stop()
        try:
            run(go())
        finally:
            MockIdpHandler.token_value = "tok-xyz"
            srv.shutdown()

    def test_standby_web_surface_refuses_writes(self, P):
        # test_replication.py
        async def go():
            primary = await start_cp(P, self_heal=False)
            standby = await start_cp(
                P, name="cp-b", self_heal=False,
                standby_of=f"{primary.host}:{primary.port}",
                standby_ping_interval_s=0.05, standby_lease_s=0.4,
                standby_grace_s=0.15)
            web = web_mod(P).WebServer(standby.state)
            host, port = await web.start()
            st, _ = await http_get(host, port, "/api/overview")
            assert st == 200
            st, _ = await http_post(host, port, "/api/tenants",
                                    {"name": "ghost"})
            assert st == 503
            assert standby.state.store.tenant_by_name("ghost") is None
            await web.stop()
            await standby.stop()
            await primary.stop()
        run(go())


# --------------------------------------------------------------------------
# /metrics against the golden
# --------------------------------------------------------------------------

def _golden_heads() -> dict:
    out: dict = {}
    for line in GOLDEN.read_text().splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            out.setdefault(line.split()[2], []).append(line)
    return out


def test_metrics_exposition_matches_the_golden():
    """The port daemon's scrape, with the instrumented surface imported as
    scripts/check_metrics_endpoint.py imports the reference's, parses as
    the exposition format with every required family (the script's own
    check), and carries every family of the golden with its HELP and TYPE
    lines, apart from test_torch_metrics.py's listed exceptions, and
    nothing else."""
    import importlib.util
    for m in ("agent.agent", "agent.monitor", "chaos.simulate",
              "chaos.worldgen", "cloud.provider", "cp.autoscaler",
              "solver.api", "solver.multiplex", "solver.sharded"):
        importlib.import_module(f"fleetflow_tpu_torch.{m}")
    from fleetflow_tpu_torch.daemon.web import WebServer
    spec = importlib.util.spec_from_file_location(
        "check_metrics_endpoint", REPO / "scripts" /
        "check_metrics_endpoint.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)

    async def go():
        handle = await start_cp(PORT, auth_kind="token", auth_secret="s3")
        web = WebServer(handle.state)
        host, port = await web.start()
        tok = handle.state.auth.issue("m@x", ["read:health"])

        def fetch():
            import urllib.request
            req = urllib.request.Request(f"http://{host}:{port}/metrics")
            req.add_header("Authorization", f"Bearer {tok}")
            with urllib.request.urlopen(req, timeout=5) as resp:
                return resp.status, resp.headers["Content-Type"], \
                    resp.read().decode()
        out = await asyncio.get_running_loop().run_in_executor(None, fetch)
        await web.stop()
        await handle.stop()
        return out
    st, ctype, text = run(go())
    assert st == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert check.validate_format(text) == []
    got: dict = {}
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            got.setdefault(line.split()[2], []).append(line)
    golden = _golden_heads()
    assert set(got) == set(golden) - set(NOT_REGISTERED)
    for name, lines in got.items():
        if name in HELP_EXCEPTIONS:
            assert lines[1] == golden[name][1] and lines[0] != golden[name][0]
        else:
            assert lines == golden[name], name


# --------------------------------------------------------------------------
# the health checker
# --------------------------------------------------------------------------

class TestHealthChecker:
    def test_transitions_and_churn(self):
        async def go():
            handle = await start_cp(PORT)
            db = handle.state.store
            clock = [1000.0]
            hc = HealthChecker(handle.state, interval_s=999,
                               stale_after_s=90, clock=lambda: clock[0])
            db.register_server("n1")
            db.heartbeat("n1")
            s = db.server_by_slug("n1")
            db.update("servers", s.id, last_heartbeat=clock[0] - 10)
            hc.run_check()
            assert db.server_by_slug("n1").status == "online"
            clock[0] += 1000
            assert "n1" in hc.run_check()
            assert db.server_by_slug("n1").status == "offline"
            db.update("servers", s.id, last_heartbeat=clock[0] - 5)
            assert "n1" in hc.run_check()
            assert db.server_by_slug("n1").status == "online"
            await handle.stop()
        run(go())

    def test_tailscale_fallback_for_agentless_servers(self):
        async def go():
            handle = await start_cp(PORT)
            db = handle.state.store
            status = json.dumps({"Peer": {
                "k1": {"HostName": "Edge-1", "Online": True}}})
            hc = HealthChecker(handle.state, interval_s=999,
                               stale_after_s=90, clock=lambda: 1000.0,
                               use_tailscale=True,
                               tailscale_runner=lambda a: (0, status))
            db.register_server("edge-1")
            db.register_server("dark-1")
            hc.run_check()
            assert db.server_by_slug("edge-1").status == "online"
            assert db.server_by_slug("dark-1").status == "offline"
            hc.tailscale_runner = lambda a: (1, "not running")
            hc.run_check()
            assert db.server_by_slug("edge-1").status == "offline"
            await handle.stop()
        run(go())

    def test_statuses_equal_the_reference(self):
        """The same store and clock through both packages' checkers: the
        same statuses and changed slugs, sweep by sweep."""
        from fleetflow_tpu.daemon.health import HealthChecker as RefHC
        steps = [("n1", -10), ("n2", -200), ("n3", None)]

        async def drive(P, cls):
            handle = await start_cp(P)
            db = handle.state.store
            clock = [5000.0]
            hc = cls(handle.state, interval_s=999, stale_after_s=90,
                     clock=lambda: clock[0])
            for slug, age in steps:
                db.register_server(slug)
                if age is not None:
                    db.update("servers", db.server_by_slug(slug).id,
                              last_heartbeat=clock[0] + age)
            out = [(sorted(hc.run_check()), hc.resolve_statuses())]
            clock[0] += 100
            out.append((sorted(hc.run_check()), hc.resolve_statuses()))
            await handle.stop()
            return out
        assert run(drive(PORT, HealthChecker)) == run(drive(REF, RefHC))


# --------------------------------------------------------------------------
# the daemon: on the card, or not at all
# --------------------------------------------------------------------------

def _daemon_cfg(tmp_path, **kw) -> DaemonConfig:
    return DaemonConfig(pid_file=str(tmp_path / "d.pid"),
                        listen_port=free_port(), web_port=0, db_path=None,
                        tls_dir=None, **kw).expand()


class TestDaemon:
    def test_starts_on_the_card_scheduler(self, tmp_path):
        """device="cpu": the card scheduler's plain versions place a stage
        through the daemon's control plane, and the REST surface is up."""
        cfg = _daemon_cfg(tmp_path, device="cpu")

        async def go():
            d = Daemon(cfg)
            await d.start()
            svc = d.cp.state.placement
            assert svc.use_gpu and str(svc._sched_gpu.device) == "cpu"
            host, port = d.web_addr
            st, body = await http_get(host, port, "/api/health")
            assert st == 200 and body["status"] == "ok"
            await d.stop()
        run(go())

    def test_start_raises_without_cuda_before_listening(self, tmp_path):
        cfg = _daemon_cfg(tmp_path)

        async def go():
            d = Daemon(cfg)
            with pytest.raises(DeviceUnavailable, match=NO_CUDA):
                await d.start()
            assert d.cp is None and d.web is None
        run(go())
        # nothing listens on the configured port
        with socket.socket() as s:
            s.bind(("127.0.0.1", cfg.listen_port))

    def test_cli_daemon_run_exits_1_without_cuda(self, tmp_path, capsys):
        from fleetflow_tpu_torch.cli.main import main
        p = tmp_path / "fleetflowd.kdl"
        p.write_text(f'pid-file "{tmp_path}/d.pid"\n'
                     f'listen "127.0.0.1" {free_port()}\n'
                     'web enabled=#false\ndb "memory"\ntls-dir ""\n')
        assert main(["cp", "daemon", "run", "-c", str(p)]) == 1
        err = capsys.readouterr().err
        assert err.startswith("error: ") and NO_CUDA in err
        assert not (tmp_path / "d.pid").exists()


class TestDaemonizedStart:
    """`python -m fleetflow_tpu_torch.daemon start` reports a failed start
    with a nonzero exit, a started one with its pid."""

    def _cfg(self, tmp_path, port, web=True, device="cpu"):
        p = tmp_path / "fleetflowd.kdl"
        p.write_text(
            f'pid-file "{tmp_path}/d.pid"\n'
            f'log-file "{tmp_path}/d.log"\n'
            f'listen "127.0.0.1" {port}\n'
            f'tls-dir "{tmp_path}/ca"\n'
            'db "memory"\n'
            + ('web "127.0.0.1" 0\n' if web else 'web enabled=#false\n')
            + (f'solver-device "{device}"\n' if device else ""))
        return str(p)

    def _run(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "fleetflow_tpu_torch.daemon", *args],
            capture_output=True, text=True, timeout=90, cwd=str(REPO))

    def test_start_failure_is_nonzero(self, tmp_path):
        blocker = socket.socket()
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        try:
            out = self._run("start", "-c", self._cfg(tmp_path, port))
            assert out.returncode == 1, out.stdout + out.stderr
            assert "failed to start" in out.stderr and "d.log" in out.stderr
        finally:
            blocker.close()

    def test_start_without_cuda_names_the_fault(self, tmp_path):
        out = self._run("start", "-c", self._cfg(tmp_path, free_port(),
                                                 device=None))
        assert out.returncode == 1, out.stdout + out.stderr
        assert "failed to start" in out.stderr
        assert "DeviceUnavailable" in out.stderr and NO_CUDA in out.stderr
        assert not (tmp_path / "d.pid").exists()

    def test_start_success_reports_pid_then_stops(self, tmp_path):
        pytest.importorskip("cryptography")
        cfg = self._cfg(tmp_path, free_port())
        out = self._run("start", "-c", cfg)
        try:
            assert out.returncode == 0, out.stdout + out.stderr
            assert "started fleetflowd (pid" in out.stdout
            st = self._run("status", "-c", cfg)
            assert st.returncode == 0 and st.stdout.startswith("running")
        finally:
            self._run("stop", "-c", cfg)
        # the daemon removes its pid file on SIGTERM
        for _ in range(400):
            if not (tmp_path / "d.pid").exists():
                break
            time.sleep(0.05)
        assert not (tmp_path / "d.pid").exists()
