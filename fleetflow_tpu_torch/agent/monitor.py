"""Container monitor: observation + anomaly detection.

Analog of fleet-agent monitor.rs: discover runtimes, inventory every
container with fleetflow label attribution (:170-243), and detect anomalies
(:472-578):

  restart_loop     restart count increased by >= threshold since last look
  unexpected_stop  running -> exited/dead without a deploy having asked
  unhealthy        health == unhealthy

Alerts carry a 300s cooldown per (container, kind) and auto-resolve events
fire when the condition clears (monitor.rs:26-32,526-578). Detection is a
pure function over (previous, current) snapshots — exactly how the
reference unit-tests it (monitor.rs:642-759).

The port's copy of ``fleetflow_tpu/agent/monitor.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from ..obs.metrics import REGISTRY
from ..runtime.backend import ContainerBackend, ContainerInfo

__all__ = ["ContainerSnapshot", "Anomaly", "detect_anomalies",
           "AnomalyDetector", "snapshot_backend", "inventory_report",
           "DEFAULT_RESTART_THRESHOLD", "ALERT_COOLDOWN_S"]

DEFAULT_RESTART_THRESHOLD = 3   # monitor.rs:26-32
ALERT_COOLDOWN_S = 300.0

# metric catalog: docs/guide/10-observability.md. Counted at REPORT time
# (post-cooldown), so the numbers match the alerts the CP actually saw.
_M_ANOMALIES = REGISTRY.counter(
    "fleet_agent_anomalies_total",
    "Container anomalies reported, by kind "
    "(restart_loop/unexpected_stop/unhealthy)", labels=("kind",))
_M_RESOLVED = REGISTRY.counter(
    "fleet_agent_anomalies_resolved_total",
    "Container anomaly auto-resolves reported, by kind", labels=("kind",))


@dataclass(frozen=True)
class ContainerSnapshot:
    """One container's observed state at a point in time."""
    name: str
    state: str                      # running|exited|dead|created|...
    health: Optional[str] = None
    restart_count: int = 0
    image: str = ""
    labels: tuple = ()              # ((k, v), ...) hashable
    runtime: str = "docker"

    @classmethod
    def from_info(cls, info: ContainerInfo,
                  runtime: str = "docker") -> "ContainerSnapshot":
        return cls(name=info.name, state=info.state, health=info.health,
                   restart_count=info.restart_count, image=info.image,
                   labels=tuple(sorted(info.labels.items())), runtime=runtime)

    def label(self, key: str) -> Optional[str]:
        for k, v in self.labels:
            if k == key:
                return v
        return None


@dataclass(frozen=True)
class Anomaly:
    container: str
    kind: str                       # restart_loop|unexpected_stop|unhealthy
    message: str
    resolved: bool = False


def detect_anomalies(prev: dict[str, ContainerSnapshot],
                     curr: dict[str, ContainerSnapshot],
                     restart_threshold: int = DEFAULT_RESTART_THRESHOLD,
                     ) -> list[Anomaly]:
    """Pure anomaly table (monitor.rs detect_anomalies:472): compare two
    snapshots, emit raise/resolve events. Cooldown is the caller's concern
    (AnomalyDetector) so this stays a pure function."""
    out: list[Anomaly] = []
    for name, c in curr.items():
        p = prev.get(name)
        # restart loop: count increased by >= threshold between looks
        if p is not None and c.restart_count - p.restart_count >= restart_threshold:
            out.append(Anomaly(name, "restart_loop",
                               f"restart count {p.restart_count} -> "
                               f"{c.restart_count}"))
        elif (p is not None and p.restart_count > c.restart_count == 0
              and c.state == "running"):
            # container recreated; old loop is moot
            out.append(Anomaly(name, "restart_loop", "", resolved=True))

        # unexpected stop: was running, now exited/dead
        if (p is not None and p.state == "running"
                and c.state in ("exited", "dead")):
            out.append(Anomaly(name, "unexpected_stop",
                               f"{p.state} -> {c.state}"))
        elif p is not None and p.state in ("exited", "dead") and c.state == "running":
            out.append(Anomaly(name, "unexpected_stop", "", resolved=True))

        # unhealthy
        if c.health == "unhealthy":
            out.append(Anomaly(name, "unhealthy",
                               f"healthcheck failing ({c.state})"))
        elif p is not None and p.health == "unhealthy" and c.health == "healthy":
            out.append(Anomaly(name, "unhealthy", "", resolved=True))
    return out


class AnomalyDetector:
    """Stateful wrapper: snapshot diffing + per-(container, kind) alert
    cooldown + auto-resolve tracking (monitor.rs:526-578)."""

    def __init__(self, restart_threshold: int = DEFAULT_RESTART_THRESHOLD,
                 cooldown_s: float = ALERT_COOLDOWN_S, clock=time.monotonic):
        self.restart_threshold = restart_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._prev: dict[str, ContainerSnapshot] = {}
        self._last_alert: dict[tuple[str, str], float] = {}
        self._active: set[tuple[str, str]] = set()

    def observe(self, curr: dict[str, ContainerSnapshot]) -> list[Anomaly]:
        """Returns the anomalies to REPORT this round (cooldown-filtered
        raises + resolves for previously-active alerts)."""
        raw = detect_anomalies(self._prev, curr, self.restart_threshold)
        now = self.clock()
        report: list[Anomaly] = []
        for a in raw:
            key = (a.container, a.kind)
            if a.resolved:
                if key in self._active:
                    self._active.discard(key)
                    report.append(a)
                continue
            last = self._last_alert.get(key)
            if last is not None and now - last < self.cooldown_s:
                continue
            self._last_alert[key] = now
            self._active.add(key)
            report.append(a)
        # vanished containers auto-resolve their active alerts
        for key in list(self._active):
            cname = key[0]
            if cname in self._prev and cname not in curr:
                self._active.discard(key)
                report.append(Anomaly(cname, key[1], "container removed",
                                      resolved=True))
        self._prev = dict(curr)
        for a in report:
            (_M_RESOLVED if a.resolved else _M_ANOMALIES).inc(kind=a.kind)
        return report


def snapshot_backend(backend: ContainerBackend,
                     runtime: str = "docker") -> dict[str, ContainerSnapshot]:
    """Inventory one runtime (monitor.rs discovery loop :98-143; podman
    sockets become additional ContainerBackend instances)."""
    return {info.name: ContainerSnapshot.from_info(info, runtime)
            for info in backend.list(all=True)}


def inventory_report(snapshots: dict[str, ContainerSnapshot]) -> list[dict]:
    """The observed-container rows shipped to the CP (monitor.rs:170-243),
    with fleetflow label attribution."""
    rows = []
    for snap in snapshots.values():
        rows.append({
            "name": snap.name,
            "image": snap.image,
            "state": snap.state,
            "health": snap.health,
            "restart_count": snap.restart_count,
            "project": snap.label("fleetflow.project"),
            "stage": snap.label("fleetflow.stage"),
            "service": snap.label("fleetflow.service"),
            "runtime": snap.runtime,
        })
    return rows
