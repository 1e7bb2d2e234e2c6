"""Cadence sampler feeding the in-process TSDB (obs/tsdb.py; the port's
copy of ``fleetflow_tpu/obs/collector.py``).

The collector is the bridge between the point-in-time surfaces and the
fleet horizon: on every tick it scrapes the metrics registry (counters
raw, gauges direct, histograms as _sum/_count), runs the registered
*deep sources* (callables the CP wires over live subsystem state —
per-tenant admission queues, slot-manager byte accounting, log-router
backlogs, reconverger debt), and folds agent-shipped heartbeat
snapshots into agent-labeled series. Three deployment shapes, one
class:

  CP daemon    `spawn()` on the server's asyncio loop (cp/server.py
               _build_collector), stopped with the server
  benchmark    `start_thread()` — a plain daemon thread at a fast
               cadence while a leg runs
  chaos        no loop at all: the runner calls `sample_once()` at
               deterministic points on the VirtualClock with
               `registry=None`, so the capture holds only world-derived
               series and replays byte-identically (the process-global
               registry carries cross-test residue that must never leak
               into a pinned artifact)

This module must stay importable from host-only control planes: no torch,
no heavy imports — the deep gauges it *registers* (below) are set by
sources the CP builds; solver-side families (dispatches in flight,
device byte drift) register in solver/ and sched/ and arrive through
the ordinary registry scrape.

Agent shipping: `compact_snapshot()` renders the local registry into a
small list-of-triples payload the agent attaches to its existing
heartbeat (agent/agent.py); the CP's heartbeat handler calls
`ingest_agent_snapshot()` which labels every series `agent=<slug>`.
Overhead math lives in docs/guide/10-observability.md — a few KiB per
heartbeat at the default 30 s cadence.

A source that fails is logged and skipped, as in the reference, unless it
failed for a fault of the device path itself (`cp.placement._device_fault`:
the `_slots` source reads the card scheduler's slots): that propagates out
of `sample_once`, so a missing card or a broken kernel is never read as a
gap in the series.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Iterable, Optional

from . import get_logger
from .metrics import REGISTRY, MetricsRegistry
from .tsdb import TimeSeriesDB, iter_registry_samples

log = get_logger("obs.collector")

__all__ = ["Collector", "compact_snapshot", "SNAPSHOT_SCHEMA"]

# agent heartbeat metrics payload schema; bump on shape change
SNAPSHOT_SCHEMA = 1

# hard cap on entries accepted from ONE agent snapshot: bounds what a
# misbehaving (or enormous shared-registry test) agent can inflate the
# CP's series population by per heartbeat
MAX_SNAPSHOT_ENTRIES = 512

# metric catalog: docs/guide/10-observability.md
_M_SAMPLES = REGISTRY.counter(
    "fleet_obs_samples_total",
    "Samples folded into the in-process time-series store by the "
    "collector (registry scrape + deep sources + agent snapshots)")
_M_SERIES = REGISTRY.gauge(
    "fleet_obs_series",
    "Live series in the in-process time-series store")
_M_SERIES_DROPPED = REGISTRY.counter(
    "fleet_obs_series_dropped_total",
    "New series refused by the store's max-series cap (label-cardinality "
    "guard; existing series keep recording)")
_M_AGENT_SNAPSHOTS = REGISTRY.counter(
    "fleet_obs_agent_snapshots_total",
    "Heartbeat-shipped agent metric snapshots merged into agent-labeled "
    "series")

# deep gauges set by the CP's collector sources (cp/server.py
# _build_collector) — registered here so the exposition surface exists
# on any process that builds a collector, torch-free
_M_TENANT_DEPTH = REGISTRY.gauge(
    "fleet_admission_tenant_queue_depth",
    "Queued admission arrivals per tenant (deep-sampled by the "
    "collector from the admission controller)",
    labels=("tenant",))
_M_TENANT_OLDEST = REGISTRY.gauge(
    "fleet_admission_tenant_oldest_age_seconds",
    "Age of the oldest queued admission arrival per tenant",
    labels=("tenant",))
_M_LOG_BACKLOG = REGISTRY.gauge(
    "fleet_log_router_backlog_lines",
    "Lines queued across all live log-router subscribers (per-subscriber "
    "series live in the TSDB only — subscriber ids are unbounded)")
_M_RECONV_DEBT = REGISTRY.gauge(
    "fleet_reconverge_redelivery_debt",
    "Stages with active (non-parked) reconverger redelivery work")
_M_RES_BUDGET = REGISTRY.gauge(
    "fleet_sched_resident_budget_bytes",
    "Configured resident-slot byte budget (FLEET_RESIDENT_BYTES) — "
    "compare against fleet_solver_resident_bytes")


def compact_snapshot(registry: MetricsRegistry = REGISTRY,
                     max_entries: int = MAX_SNAPSHOT_ENTRIES) -> dict:
    """The agent-side heartbeat payload: [name, labels, value, kind]
    triples in deterministic order, histograms flattened to _sum/_count.
    Deliberately small and schema-versioned — it crosses the wire every
    heartbeat_interval_s."""
    entries = []
    for name, labels, value, kind in iter_registry_samples(
            registry.snapshot()):
        entries.append([name, labels, value, kind])
    entries.sort(key=lambda e: (e[0], sorted(e[1].items())))
    truncated = len(entries) > max_entries
    return {"schema": SNAPSHOT_SCHEMA,
            "m": entries[:max_entries],
            "truncated": truncated}


class Collector:
    """Samples the registry + deep sources into a TimeSeriesDB on a
    cadence, and merges agent heartbeat snapshots.

    `sources` are callables `fn(now) -> Optional[iterable]` run under
    no lock of the collector's own — they read their subsystem with its
    locking discipline and either set registry gauges (picked up by the
    scrape half) or return (name, labels, value, kind) tuples recorded
    TSDB-only (the right shape for unbounded-cardinality series like
    per-subscriber backlogs). Within one pass, returned entries override
    the scrape for the same (name, labels) so a sample is recorded
    exactly once per tick."""

    def __init__(self, tsdb: TimeSeriesDB, *,
                 interval_s: float = 5.0,
                 registry: Optional[MetricsRegistry] = REGISTRY,
                 clock: Optional[Callable[[], float]] = None):
        self.tsdb = tsdb
        self.interval_s = float(interval_s)
        self.registry = registry
        self.clock = clock or tsdb.clock
        self._sources: list[Callable] = []
        self._agents_seen: set[str] = set()
        self._last_sample_t: Optional[float] = None
        self._task: Optional[asyncio.Task] = None
        self._thread: Optional[threading.Thread] = None
        self._thread_stop = threading.Event()

    def add_source(self, fn: Callable[[float], Optional[Iterable]]) -> None:
        self._sources.append(fn)

    # -- one pass ------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """One sampling pass; returns samples recorded. Deterministic
        given deterministic sources + clock (the chaos capture contract:
        registry=None keeps process-global residue out)."""
        t = self.clock() if now is None else float(now)
        batch: dict[tuple, tuple] = {}
        if self.registry is not None:
            for name, labels, value, kind in iter_registry_samples(
                    self.registry.snapshot()):
                key = (name, tuple(sorted(labels.items())))
                batch[key] = (name, labels, value, kind)
        for src in self._sources:
            try:
                extra = src(t)
            except Exception as e:
                from ..cp.placement import _device_fault
                if _device_fault(e):
                    raise
                log.exception("collector source failed")
                continue
            for entry in extra or ():
                name, labels, value = entry[0], entry[1], entry[2]
                kind = entry[3] if len(entry) > 3 else "gauge"
                key = (name, tuple(sorted((labels or {}).items())))
                batch[key] = (name, labels, value, kind)
        recorded = 0
        dropped0 = self.tsdb.dropped_series
        for name, labels, value, kind in batch.values():
            if self.tsdb.record(name, value, labels=labels, t=t,
                                kind=kind):
                recorded += 1
        self._last_sample_t = t
        if self.registry is not None:
            _M_SAMPLES.inc(recorded)
            dropped = self.tsdb.dropped_series - dropped0
            if dropped:
                _M_SERIES_DROPPED.inc(dropped)
            _M_SERIES.set(len(self.tsdb))
        return recorded

    # -- agent shipping ------------------------------------------------

    def ingest_agent_snapshot(self, slug: str, payload: dict,
                              now: Optional[float] = None) -> int:
        """Merge one heartbeat-shipped snapshot into `agent=<slug>`
        labeled series; returns samples recorded. Malformed entries are
        skipped, never raised — a bad agent must not take down the
        heartbeat path."""
        if not isinstance(payload, dict) or payload.get("schema") != \
                SNAPSHOT_SCHEMA:
            return 0
        t = self.clock() if now is None else float(now)
        recorded = 0
        for entry in list(payload.get("m") or ())[:MAX_SNAPSHOT_ENTRIES]:
            try:
                name, labels, value = entry[0], dict(entry[1]), \
                    float(entry[2])
                kind = entry[3] if len(entry) > 3 else "gauge"
            except (TypeError, ValueError, IndexError, KeyError):
                continue
            labels["agent"] = slug
            if self.tsdb.record(str(name), value, labels=labels, t=t,
                                kind=str(kind)):
                recorded += 1
        self._agents_seen.add(slug)
        if self.registry is not None:
            _M_AGENT_SNAPSHOTS.inc()
            _M_SAMPLES.inc(recorded)
            _M_SERIES.set(len(self.tsdb))
        return recorded

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        out = self.tsdb.stats()
        out.update({"interval_s": self.interval_s,
                    "agents": sorted(self._agents_seen),
                    "last_sample_t": self._last_sample_t,
                    "sources": len(self._sources)})
        return out

    # -- asyncio loop (CP daemon) --------------------------------------

    async def run_loop(self) -> None:
        while True:
            try:
                self.sample_once()
            except Exception:
                log.exception("collector sampling pass failed")
            await asyncio.sleep(self.interval_s)

    def spawn(self) -> None:
        self._task = asyncio.ensure_future(self.run_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -- thread loop (benchmark) ---------------------------------------

    def start_thread(self) -> None:
        self._thread_stop.clear()

        def _loop() -> None:
            while not self._thread_stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:
                    log.exception("collector sampling pass failed")

        self._thread = threading.Thread(
            target=_loop, name="fleet-obs-collector", daemon=True)
        self._thread.start()

    def stop_thread(self, timeout: float = 2.0) -> None:
        self._thread_stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


def wait_for_series(collector: Collector, name: Optional[str] = None,
                    labels: Optional[dict] = None,
                    timeout: float = 5.0) -> bool:
    """Test/CI helper: poll (wall clock) until a matching series exists
    — scripts/check_fleet_top.py waits for agent-labeled series this
    way instead of sleeping a fixed heartbeat multiple."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if collector.tsdb.match(name, labels):
            return True
        time.sleep(0.02)
    return bool(collector.tsdb.match(name, labels))
