"""Daemon configuration.

Analog of fleetflowd config.rs:7-57: a `fleetflowd.kdl` file holding
pid/log/listen/db/auth/web/health-interval settings, discovered through the
search chain: explicit path -> ./fleetflowd.kdl -> ~/.config/fleetflow/
fleetflowd.kdl -> /etc/fleetflow/fleetflowd.kdl.

The placement service solves on the card: `use_gpu_solver` is on by
default (the reference's `use_tpu_solver` is off), and `device` names the
card scheduler's device (None: the card, and the daemon refuses to start
without CUDA). The reference's `tpu-solver`/`use-tpu-solver` keys set
`use_gpu_solver`, as does `gpu-solver`; `solver-device "cpu"` runs the card
scheduler's plain PyTorch versions on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..core.kdl import bool_value, parse_document

__all__ = ["DaemonConfig", "load_daemon_config", "config_search_paths"]


@dataclass
class DaemonConfig:
    """config.rs DaemonConfig:7-18."""
    pid_file: str = "~/.local/state/fleetflow/fleetflowd.pid"
    log_file: Optional[str] = None
    listen_host: str = "127.0.0.1"
    listen_port: int = 4510
    web_host: str = "127.0.0.1"
    web_port: int = 32080
    web_enabled: bool = True
    db_path: Optional[str] = "~/.local/state/fleetflow/cp.json"
    auth_kind: str = "none"
    auth_secret: Optional[str] = None
    auth_jwks: Optional[str] = None
    auth_issuer: Optional[str] = None
    auth_audience: Optional[str] = None
    auth_client_id: Optional[str] = None
    tls_dir: Optional[str] = "~/.local/state/fleetflow/ca"
    health_tailscale: bool = False
    health_interval_s: float = 60.0        # config.rs:33
    heartbeat_stale_s: float = 90.0
    autoscale_interval_s: float = 0.0      # 0 = autoscaler off
    use_gpu_solver: bool = True
    # the card scheduler's device: None = the card (no CUDA refuses to
    # start); "cpu" runs its plain versions on the host
    device: Optional[str] = None
    # self-healing (docs/guide/12-self-healing.md): lease-based failure
    # detection + automatic re-solve/redeploy of a dead node's services
    self_heal: bool = True
    lease_s: float = 90.0
    suspect_grace_s: float = 30.0
    heal_interval_s: float = 5.0
    # replication (docs/guide/13-cp-replication.md): set standby-of to
    # run this daemon as a warm standby of that primary; it streams the
    # journal, watches the primary's lease, and promotes itself on death
    standby_of: Optional[str] = None
    standby_token: Optional[str] = None
    standby_ping_interval_s: float = 2.0
    standby_lease_s: float = 10.0
    standby_grace_s: float = 5.0
    # streaming admission (docs/guide/14-streaming-admission.md):
    # continuous arrivals/departures as bucketed micro-solves with
    # backpressure + tenant fairness
    admission: bool = True
    admission_queue: int = 4096
    admission_batch: int = 128
    admission_shed_age_s: float = 120.0
    # rolling SLO objectives (docs/guide/10, "solver flight deck"):
    # `slo placement-p99-ms=50 heal-p99-s=30 ...` — each prop is
    # <stream>-p<NN>-<unit>=<threshold>, validated at load time
    slo: dict = field(default_factory=dict)
    source: Optional[str] = None

    def expand(self) -> "DaemonConfig":
        for attr in ("pid_file", "log_file", "db_path", "tls_dir"):
            v = getattr(self, attr)
            if v:
                setattr(self, attr, os.path.expanduser(v))
        return self


def config_search_paths(explicit: Optional[str] = None) -> list[Path]:
    """config.rs:43-57 search order."""
    paths = []
    if explicit:
        paths.append(Path(explicit))
    paths.append(Path("fleetflowd.kdl"))
    paths.append(Path.home() / ".config" / "fleetflow" / "fleetflowd.kdl")
    paths.append(Path("/etc/fleetflow/fleetflowd.kdl"))
    return paths


def load_daemon_config(explicit: Optional[str] = None) -> DaemonConfig:
    # an explicitly named config that doesn't exist is an error, never a
    # silent fall-through to defaults (a typo'd -c must not start the
    # daemon with localhost/no-auth settings)
    if explicit and not Path(explicit).is_file():
        raise FileNotFoundError(f"daemon config {explicit!r} not found")
    cfg = DaemonConfig()
    for path in config_search_paths(explicit):
        if path.is_file():
            _apply_kdl(cfg, path.read_text())
            cfg.source = str(path)
            break
    return cfg.expand()


# shared KDL bool coercion (core.kdl.bool_value): bare-word false must
# never coerce truthy
_truthy = bool_value


def _apply_kdl(cfg: DaemonConfig, text: str) -> None:
    for node in parse_document(text):
        n, v = node.name, node.arg(0)
        if n == "pid-file":
            cfg.pid_file = str(v)
        elif n == "log-file":
            cfg.log_file = str(v)
        elif n == "listen":
            # `listen "0.0.0.0" 4510` or `listen host="0.0.0.0" port=4510`
            cfg.listen_host = str(node.prop("host", node.arg(0, cfg.listen_host)))
            cfg.listen_port = int(node.prop("port", node.arg(1, cfg.listen_port)))
        elif n == "web":
            cfg.web_enabled = _truthy(node.prop("enabled", True), node)
            cfg.web_host = str(node.prop("host", node.arg(0, cfg.web_host)))
            cfg.web_port = int(node.prop("port", node.arg(1, cfg.web_port)))
        elif n == "db":
            cfg.db_path = str(v) if v not in (None, "memory") else None
        elif n == "auth":
            cfg.auth_kind = str(v or "none")
            secret = node.prop("secret")
            if secret is not None:
                cfg.auth_secret = str(secret)
            for key in ("jwks", "issuer", "audience"):
                val = node.prop(key)
                if val is not None:
                    setattr(cfg, f"auth_{key}", str(val))
            client_id = node.prop("client-id")
            if client_id is not None:
                cfg.auth_client_id = str(client_id)
        elif n == "tls-dir":
            cfg.tls_dir = str(v) if v else None
        elif n == "health-interval":
            cfg.health_interval_s = float(v)
        elif n == "health-tailscale":
            cfg.health_tailscale = _truthy(v, node)
        elif n == "heartbeat-stale":
            cfg.heartbeat_stale_s = float(v)
        elif n == "autoscale-interval":
            cfg.autoscale_interval_s = float(v)
        elif n in ("tpu-solver", "use-tpu-solver", "gpu-solver"):
            cfg.use_gpu_solver = _truthy(v, node)
        elif n == "solver-device":
            # `solver-device "cpu"`: the card scheduler's plain versions
            # (a daemonized process has no other way to ask for the CPU)
            cfg.device = str(v) if v not in (None, "") else None
        elif n == "replication":
            # `replication standby-of="primary:4510" lease=10 grace=5
            #  ping=2 token="..."` — omit the node (or standby-of) to run
            # as a primary; standbys dial the primary's listen port
            sb = node.prop("standby-of", node.arg(0))
            if sb is not None:
                cfg.standby_of = str(sb)
            token = node.prop("token")
            if token is not None:
                cfg.standby_token = str(token)
            for prop, attr in (("ping", "standby_ping_interval_s"),
                               ("lease", "standby_lease_s"),
                               ("grace", "standby_grace_s")):
                val = node.prop(prop)
                if val is not None:
                    setattr(cfg, attr, float(val))
        elif n == "self-heal":
            # `self-heal false` disables; props tune the lease machinery:
            # `self-heal lease=90 grace=30 interval=5`
            if v is not None:
                cfg.self_heal = _truthy(v, node)
            lease = node.prop("lease")
            if lease is not None:
                cfg.lease_s = float(lease)
            grace = node.prop("grace")
            if grace is not None:
                cfg.suspect_grace_s = float(grace)
            interval = node.prop("interval")
            if interval is not None:
                cfg.heal_interval_s = float(interval)
        elif n == "slo":
            # `slo placement-p99-ms=50 heal-p99-s=30` — every prop is an
            # objective; validate the grammar NOW so a typo'd stream
            # fails daemon start instead of becoming a never-sampled,
            # vacuously-met objective
            from ..obs.slo import parse_slo_props
            props = {k: float(v) for k, v in node.props.items()}
            parse_slo_props(props)
            cfg.slo.update(props)
        elif n == "admission":
            # `admission false` disables streaming admission; props tune
            # the watermarks: `admission queue=4096 batch=128 shed-age=120`
            if v is not None:
                cfg.admission = _truthy(v, node)
            for prop, attr, cast in (("queue", "admission_queue", int),
                                     ("batch", "admission_batch", int),
                                     ("shed-age", "admission_shed_age_s",
                                      float)):
                pv = node.prop(prop)
                if pv is not None:
                    setattr(cfg, attr, cast(pv))
