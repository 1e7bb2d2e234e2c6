"""Container backends: the runtime boundary (the port's copy of
``fleetflow_tpu/runtime/backend.py``).

The reference talks to dockerd through Bollard (a Rust client for the Docker
Engine API). Here the boundary is a small `ContainerBackend` protocol with
two implementations:

  DockerCliBackend  shells out to the `docker` CLI (the engine API surface we
                    actually use: create/start/stop/rm/pull/network/inspect/
                    ps/logs/exec/restart)
  MockBackend       deterministic in-memory implementation for Tier-1 tests
                    (the reference's "no Docker in fast tests", ci.yml:15-70)

State transitions in MockBackend follow the 7-state lifecycle of
model/process.rs:43 so waiter/monitor logic is testable against it.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Optional, Protocol

from ..core.errors import FlowError
from .converter import ContainerConfig

__all__ = ["ContainerBackend", "ContainerInfo", "MockBackend",
           "DockerCliBackend", "BackendError"]


class BackendError(FlowError):
    pass


@dataclass
class ContainerInfo:
    """Inspect result subset the engine/waiter/monitor need."""
    id: str
    name: str
    image: str
    state: str = "created"            # created|running|paused|restarting|exited|dead
    health: Optional[str] = None      # starting|healthy|unhealthy|None
    restart_count: int = 0
    exit_code: Optional[int] = None
    labels: dict[str, str] = field(default_factory=dict)
    ports: dict[str, str] = field(default_factory=dict)   # "8080/tcp" -> host

    @property
    def running(self) -> bool:
        return self.state == "running"


class ContainerBackend(Protocol):
    def ping(self) -> bool: ...
    def pull(self, image: str) -> None: ...
    def ensure_network(self, name: str) -> None: ...
    def remove_network(self, name: str) -> None: ...
    def create(self, cfg: ContainerConfig) -> str: ...
    def start(self, name_or_id: str) -> None: ...
    def stop(self, name_or_id: str, timeout: int = 10) -> None: ...
    def restart(self, name_or_id: str) -> None: ...
    def remove(self, name_or_id: str, force: bool = False) -> None: ...
    def inspect(self, name_or_id: str) -> Optional[ContainerInfo]: ...
    def list(self, label_filter: Optional[dict[str, str]] = None,
             all: bool = True) -> list[ContainerInfo]: ...
    def logs(self, name_or_id: str, tail: int = 100,
             since: Optional[str] = None) -> str: ...
    def prune_images(self, older_than_hours: int = 168) -> int: ...


# --------------------------------------------------------------------------
# Mock backend (Tier-1 tests)
# --------------------------------------------------------------------------

class MockBackend:
    """In-memory backend. Deterministic; records every call for assertions.

    `fail_on` maps "op:name" (e.g. "start:myproj-local-app", "pull:redis:7")
    to an exception count — the call fails that many times then succeeds,
    enabling retry-path tests (the 409/404 recovery logic of up.rs:329-441).
    """

    def __init__(self, auto_pull: bool = False, fault_hook=None):
        self.containers: dict[str, ContainerInfo] = {}
        self.networks: set[str] = set()
        self.images: set[str] = set()
        self.calls: list[tuple] = []
        self.fail_on: dict[str, int] = {}
        self._next_id = 0
        self.pruned = 0
        self.auto_pull = auto_pull   # dev mode: any pull "succeeds"
        # fault_hook(op, name) consulted wherever fail_on is (create/
        # start/pull); raising BackendError injects a failure without
        # pre-counting calls — the chaos harness's per-op fault delivery
        # point into the fake-docker backend.
        self.fault_hook = fault_hook

    # -- helpers ------------------------------------------------------------
    def _maybe_fail(self, op: str, name: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(op, name)
        key = f"{op}:{name}"
        n = self.fail_on.get(key, 0)
        if n > 0:
            self.fail_on[key] = n - 1
            raise BackendError(f"injected failure: {key}")

    def set_health(self, name: str, health: Optional[str]) -> None:
        self.containers[name].health = health

    def set_state(self, name: str, state: str) -> None:
        self.containers[name].state = state

    # -- protocol -----------------------------------------------------------
    def ping(self) -> bool:
        return True

    def pull(self, image: str) -> None:
        self.calls.append(("pull", image))
        if not self.auto_pull:
            self._maybe_fail("pull", image)
        self.images.add(image)

    def ensure_network(self, name: str) -> None:
        self.calls.append(("ensure_network", name))
        self.networks.add(name)

    def remove_network(self, name: str) -> None:
        self.calls.append(("remove_network", name))
        self.networks.discard(name)

    def create(self, cfg: ContainerConfig) -> str:
        self.calls.append(("create", cfg.name))
        self._maybe_fail("create", cfg.name)
        if cfg.name in self.containers:
            raise BackendError(f"conflict: container {cfg.name} already exists (409)")
        if cfg.image not in self.images:
            raise BackendError(f"no such image: {cfg.image} (404)")
        self._next_id += 1
        cid = f"mock{self._next_id:08d}"
        self.containers[cfg.name] = ContainerInfo(
            id=cid, name=cfg.name, image=cfg.image, state="created",
            health="starting" if cfg.healthcheck else None,
            labels=dict(cfg.labels),
            ports={k: v[0]["HostPort"] for k, v in cfg.port_bindings.items()},
        )
        return cid

    def start(self, name_or_id: str) -> None:
        self.calls.append(("start", name_or_id))
        self._maybe_fail("start", name_or_id)
        info = self._find(name_or_id)
        if info is None:
            raise BackendError(f"no such container: {name_or_id} (404)")
        info.state = "running"
        if info.health == "starting":
            info.health = "healthy"  # mock: containers become healthy instantly

    def stop(self, name_or_id: str, timeout: int = 10) -> None:
        self.calls.append(("stop", name_or_id))
        info = self._find(name_or_id)
        if info is not None:
            info.state = "exited"
            info.exit_code = 0

    def restart(self, name_or_id: str) -> None:
        self.calls.append(("restart", name_or_id))
        info = self._find(name_or_id)
        if info is None:
            raise BackendError(f"no such container: {name_or_id} (404)")
        info.state = "running"
        info.restart_count += 1

    def remove(self, name_or_id: str, force: bool = False) -> None:
        self.calls.append(("remove", name_or_id))
        info = self._find(name_or_id)
        if info is None:
            return
        if info.running and not force:
            raise BackendError(f"container {name_or_id} is running (409)")
        del self.containers[info.name]

    def inspect(self, name_or_id: str) -> Optional[ContainerInfo]:
        return self._find(name_or_id)

    def list(self, label_filter: Optional[dict[str, str]] = None,
             all: bool = True) -> list[ContainerInfo]:
        out = []
        for info in self.containers.values():
            if not all and not info.running:
                continue
            if label_filter and any(info.labels.get(k) != v
                                    for k, v in label_filter.items()):
                continue
            out.append(info)
        return out

    def logs(self, name_or_id: str, tail: int = 100,
             since: Optional[str] = None) -> str:
        return ""

    def prune_images(self, older_than_hours: int = 168) -> int:
        self.calls.append(("prune_images", older_than_hours))
        self.pruned += 1
        return 0

    def _find(self, name_or_id: str) -> Optional[ContainerInfo]:
        if name_or_id in self.containers:
            return self.containers[name_or_id]
        for info in self.containers.values():
            if info.id == name_or_id:
                return info
        return None


# --------------------------------------------------------------------------
# Docker CLI backend
# --------------------------------------------------------------------------

class DockerCliBackend:
    """Shells out to the `docker` CLI. The reference uses the Engine API via
    Bollard; the CLI exposes the identical operations and needs no vendored
    HTTP client."""

    def __init__(self, binary: str = "docker"):
        self.binary = binary

    def _run(self, *args: str, check: bool = True,
             input: Optional[str] = None) -> subprocess.CompletedProcess:
        proc = subprocess.run([self.binary, *args], capture_output=True,
                              text=True, input=input)
        if check and proc.returncode != 0:
            raise BackendError(
                f"docker {' '.join(args[:2])} failed: {proc.stderr.strip()}")
        return proc

    def ping(self) -> bool:
        if shutil.which(self.binary) is None:
            return False
        return self._run("info", "--format", "{{.ID}}", check=False).returncode == 0

    def pull(self, image: str) -> None:
        self._run("pull", image)

    def ensure_network(self, name: str) -> None:
        probe = self._run("network", "inspect", name, check=False)
        if probe.returncode != 0:
            self._run("network", "create", name)

    def remove_network(self, name: str) -> None:
        self._run("network", "rm", name, check=False)

    def create(self, cfg: ContainerConfig) -> str:
        args = ["create", "--name", cfg.name]
        for e in cfg.env:
            args += ["-e", e]
        for key, bindings in cfg.port_bindings.items():
            cport, proto = key.split("/")
            for b in bindings:
                hostip = b.get("HostIp")
                spec = (f"{hostip}:" if hostip else "") + f"{b['HostPort']}:{cport}/{proto}"
                args += ["-p", spec]
        for bind in cfg.binds:
            args += ["-v", bind]
        if cfg.restart_policy:
            args += ["--restart", cfg.restart_policy]
        for k, v in cfg.labels.items():
            args += ["--label", f"{k}={v}"]
        if cfg.network:
            args += ["--network", cfg.network]
            for alias in cfg.aliases:
                args += ["--network-alias", alias]
        if cfg.healthcheck:
            hc = cfg.healthcheck
            test = hc["test"]
            if test and test[0] == "CMD-SHELL":
                args += ["--health-cmd", " ".join(test[1:])]
            elif test and test[0] == "CMD":
                args += ["--health-cmd", " ".join(test[1:])]
            args += ["--health-interval", f"{hc['interval'] // NS}s",
                     "--health-timeout", f"{hc['timeout'] // NS}s",
                     "--health-retries", str(hc["retries"]),
                     "--health-start-period", f"{hc['start_period'] // NS}s"]
        args.append(cfg.image)
        if cfg.command:
            args += cfg.command
        return self._run(*args).stdout.strip()

    def start(self, name_or_id: str) -> None:
        self._run("start", name_or_id)

    def stop(self, name_or_id: str, timeout: int = 10) -> None:
        self._run("stop", "-t", str(timeout), name_or_id, check=False)

    def restart(self, name_or_id: str) -> None:
        self._run("restart", name_or_id)

    def remove(self, name_or_id: str, force: bool = False) -> None:
        args = ["rm"]
        if force:
            args.append("-f")
        self._run(*args, name_or_id, check=False)

    def inspect(self, name_or_id: str) -> Optional[ContainerInfo]:
        proc = self._run("inspect", name_or_id, check=False)
        if proc.returncode != 0:
            return None
        data = json.loads(proc.stdout)[0]
        state = data.get("State", {})
        health = (state.get("Health") or {}).get("Status")
        cfg = data.get("Config", {})
        ports = {}
        for key, bindings in ((data.get("HostConfig", {}) or {})
                              .get("PortBindings") or {}).items():
            if bindings:
                ports[key] = bindings[0].get("HostPort", "")
        return ContainerInfo(
            id=data.get("Id", ""),
            name=data.get("Name", "").lstrip("/"),
            image=cfg.get("Image", ""),
            state=state.get("Status", "unknown"),
            health=health,
            restart_count=data.get("RestartCount", 0),
            exit_code=state.get("ExitCode"),
            labels=cfg.get("Labels") or {},
            ports=ports,
        )

    def list(self, label_filter: Optional[dict[str, str]] = None,
             all: bool = True) -> list[ContainerInfo]:
        args = ["ps", "--format", "{{.Names}}"]
        if all:
            args.insert(1, "-a")
        for k, v in (label_filter or {}).items():
            args += ["--filter", f"label={k}={v}"]
        proc = self._run(*args, check=False)
        names = [n for n in proc.stdout.splitlines() if n]
        return [info for n in names if (info := self.inspect(n)) is not None]

    def logs(self, name_or_id: str, tail: int = 100,
             since: Optional[str] = None) -> str:
        args = ["logs", "--tail", str(tail)]
        if since:
            args += ["--since", since]
        proc = self._run(*args, name_or_id, check=False)
        return proc.stdout + proc.stderr

    def logs_follow(self, name_or_id: str, tail: int = 100,
                    since: Optional[str] = None, on_line=print) -> int:
        """Stream logs until the container exits or the caller interrupts
        (logs.rs follow path): one on_line call per line, returns the
        docker exit code."""
        args = [self.binary, "logs", "--follow", "--tail", str(tail)]
        if since:
            args += ["--since", since]
        args.append(name_or_id)
        proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        interrupted = False
        try:
            for line in proc.stdout:
                on_line(line.rstrip("\n"))
        except KeyboardInterrupt:
            interrupted = True
            proc.terminate()
        rc = proc.wait()
        if interrupted:
            return 130     # conventional SIGINT exit; stopping follow is
        return rc if rc >= 0 else 1   # not a failure worth a weird status

    def prune_images(self, older_than_hours: int = 168) -> int:
        # reference prune policy: unused + dangling > 168h (engine.rs:458-489)
        self._run("image", "prune", "-f", "--filter",
                  f"until={older_than_hours}h", check=False)
        return 0


NS = 1_000_000_000
