"""Traffic traces: record a chaos run's primitive timeline, replay it
against a DIFFERENT world (the port's copy of
``fleetflow_tpu/chaos/trace.py``; docs/guide/18-world-simulator.md).

A trace is the bridge between the chaos harness and `fleet plan
simulate`: `fleet chaos run --record-trace` writes the schedule's fully
expanded (time, op, params) stream — arrivals, departures, correlated
faults, ticks — plus the world topology and the run's outcome, and the
simulator replays that EXACT traffic against a proposed KDL flow
through the real control-plane paths on the virtual clock.

Format: JSONL, one object per line, `kind` discriminated.

  header   {"kind": "header", "version": 1, scenario/seed/sizes,
            "tenant_caps": ..., "world": ...}
  event    {"kind": "event", "t": ..., "op": ..., "p": {...}}  (sorted)
  footer   {"kind": "footer", "digest": ..., "ok": ...,
            "baseline": <slo_summary virtual+wall buckets>,
            "stats": ...}

Every line is canonical JSON (sorted keys), so a recorded trace is
byte-reproducible from the same (scenario, seed, size) — the trace
format inherits the chaos digest contract. The footer carries the
recording run's OWN outcome: the simulator diffs a proposal's SLO
quantiles against `baseline` without re-running the baseline world.

`TraceSchedule` duck-types `faults.FaultSchedule` (events(), scenario,
seed, horizon, tenant_caps, world), so `run_schedule` replays a loaded
trace unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["TRACE_VERSION", "TraceSchedule", "write_trace", "load_trace"]

TRACE_VERSION = 1


class TraceSchedule:
    """A recorded primitive timeline wearing the FaultSchedule duck:
    `events()` returns the trace's exact (t, op, params) stream — no
    re-expansion, no re-seeding, byte-for-byte what the recording run
    applied."""

    def __init__(self, scenario: str, seed: int,
                 events: list[tuple[float, str, dict]],
                 horizon: float, tenant_caps: dict, world: dict):
        self.scenario = scenario
        self.seed = seed
        self.horizon = horizon
        self.tenant_caps = dict(tenant_caps or {})
        self.world = dict(world or {})
        self._events = list(events)

    def events(self) -> list[tuple[float, str, dict]]:
        return list(self._events)

    def describe(self) -> list[str]:
        return [f"t={t:>7.1f}s {op} "
                + " ".join(f"{k}={v}" for k, v in sorted(p.items()))
                for t, op, p in self._events]


def write_trace(path, schedule, report, *, services: int, nodes: int,
                stages: int, pool_min: int) -> None:
    """Record one run: the schedule's expanded timeline plus the run's
    sizes and outcome, as canonical JSONL."""
    lines = [json.dumps({
        "kind": "header", "version": TRACE_VERSION,
        "scenario": schedule.scenario, "seed": schedule.seed,
        "services": services, "nodes": nodes, "stages": stages,
        "pool_min": pool_min, "horizon": schedule.horizon,
        "tenant_caps": getattr(schedule, "tenant_caps", {}) or {},
        "world": getattr(schedule, "world", {}) or {},
    }, sort_keys=True)]
    for t, op, p in schedule.events():
        lines.append(json.dumps({"kind": "event", "t": t, "op": op,
                                 "p": p}, sort_keys=True))
    lines.append(json.dumps({
        "kind": "footer", "digest": report.digest(), "ok": report.ok,
        "baseline": report.slo, "stats": report.stats,
    }, sort_keys=True))
    Path(path).write_text("\n".join(lines) + "\n")


def load_trace(path) -> tuple[TraceSchedule, dict, dict]:
    """Parse a recorded trace back into a replayable schedule. Returns
    (schedule, header, footer); `footer` may be empty for a truncated
    recording (the simulator then has no baseline to diff against)."""
    header: dict = {}
    footer: dict = {}
    events: list[tuple[float, str, dict]] = []
    for i, raw in enumerate(Path(path).read_text().splitlines()):
        raw = raw.strip()
        if not raw:
            continue
        row = json.loads(raw)
        kind = row.get("kind")
        if kind == "header":
            header = row
        elif kind == "event":
            events.append((float(row["t"]), str(row["op"]),
                           dict(row["p"])))
        elif kind == "footer":
            footer = row
        else:
            raise ValueError(f"{path}: line {i + 1} has unknown "
                             f"kind {kind!r}")
    if not header:
        raise ValueError(f"{path}: no trace header found — not a "
                         f"recorded trace?")
    if header.get("version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {header.get('version')!r} != "
            f"supported {TRACE_VERSION}")
    sched = TraceSchedule(
        scenario=str(header["scenario"]), seed=int(header["seed"]),
        events=events, horizon=float(header["horizon"]),
        tenant_caps=header.get("tenant_caps") or {},
        world=header.get("world") or {})
    return sched, header, footer
