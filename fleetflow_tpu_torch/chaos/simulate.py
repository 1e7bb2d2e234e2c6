"""`fleet plan simulate`: replay a recorded traffic trace against a
PROPOSED flow before anything deploys (the port's copy of
``fleetflow_tpu/chaos/simulate.py``; docs/guide/18-world-simulator.md).

The capacity-planning loop the chaos harness earns its keep with:

  1. record — `fleet chaos run ... --record-trace t.jsonl` captures a
     run's full primitive timeline (arrivals, departures, correlated
     faults) plus the recording run's SLO quantiles as the baseline;
  2. propose — edit the KDL (add services, shrink a stage's server
     set, bump resources);
  3. simulate — `fleet plan simulate flow.kdl --trace t.jsonl` replays
     the EXACT recorded traffic against the proposed flow through the
     real control-plane paths (placement solves, admission batching,
     self-healing) on the virtual clock;
  4. judge — per-stream SLO deltas against the trace's baseline, the
     full invariant pack, and a deterministic report digest CI can pin.

Determinism: the report digests only virtual-clock material — the
event-log digest, the VIRTUAL_SLO_STREAMS quantiles (admission wait,
heal time: exact virtual arithmetic), and the replay's event-count
stats. Wall-clock streams (host solve latencies) are reported for
humans but stay OUTSIDE the digest, exactly like the chaos event-log
contract.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..obs.metrics import REGISTRY
from .runner import VIRTUAL_SLO_STREAMS, run_schedule
from .trace import load_trace

__all__ = ["simulate_flow", "report_digest", "M_SIM_RUNS",
           "M_SIM_REGRESSIONS"]

M_SIM_RUNS = REGISTRY.counter(
    "fleet_plan_simulate_runs_total",
    "Trace replays completed by `fleet plan simulate`.")
M_SIM_REGRESSIONS = REGISTRY.counter(
    "fleet_plan_simulate_regressions_total",
    "Virtual-stream p99 regressions found by `fleet plan simulate`, "
    "by SLO stream.", ["stream"])

# a proposal "regresses" a stream when its p99 exceeds the recorded
# baseline's by more than the tolerance: a pacing-granularity floor
# plus 25% headroom (virtual waits quantize to the replay's reconcile
# cadence, so tiny absolute drifts are not findings)
REGRESSION_FLOOR_S = 5.0
REGRESSION_FRAC = 0.25

# nondeterministic or derived keys the report digest must not cover
_DIGEST_EXCLUDE = ("digest", "wall_streams", "ok", "violations")


def report_digest(doc: dict) -> str:
    """sha256 over the report's deterministic core: canonical JSON with
    the wall-clock and verdict keys stripped."""
    core = {k: v for k, v in doc.items() if k not in _DIGEST_EXCLUDE}
    return hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()


def _delta(baseline: Optional[dict], proposed: Optional[dict]) -> dict:
    row: dict = {"baseline": baseline, "proposed": proposed}
    bp = (baseline or {}).get("p99")
    pp = (proposed or {}).get("p99")
    if bp is not None and pp is not None:
        row["delta_p99"] = round(float(pp) - float(bp), 6)
        bound = float(bp) + max(REGRESSION_FLOOR_S,
                                REGRESSION_FRAC * float(bp))
        row["regressed"] = float(pp) > bound
    return row


def simulate_flow(flow, trace_path, *, pool_min: Optional[int] = None,
                  validate: bool = True, device=None,
                  use_gpu: bool = True) -> dict:
    """Replay `trace_path` against `flow` and return the SLO-delta
    report dict (its `digest` key is deterministic for the same
    trace + flow). The world places on the card (`device=None`);
    `device="cpu"` runs the card scheduler's plain versions and
    `use_gpu=False` the host greedy path, as in `run_schedule`."""
    sched, header, footer = load_trace(trace_path)
    # snapshot the proposal BEFORE replay: streamed admission admits
    # the trace's arrivals into the flow, so counting afterwards would
    # describe the replayed world, not the proposed one
    proposal = {
        "flow": flow.name,
        "stages": sorted(flow.stages),
        "services": len(flow.services),
    }
    rep = run_schedule(
        sched, services=int(header["services"]),
        nodes=int(header["nodes"]), stages=int(header["stages"]),
        pool_min=int(header["pool_min"] if pool_min is None
                     else pool_min),
        flow=flow, validate=validate, device=device, use_gpu=use_gpu)
    M_SIM_RUNS.inc()

    baseline_slo = (footer.get("baseline") or {})
    streams: dict = {}
    regressions: list[str] = []
    for stream in VIRTUAL_SLO_STREAMS:
        row = _delta((baseline_slo.get("virtual") or {}).get(stream),
                     (rep.slo.get("virtual") or {}).get(stream))
        streams[stream] = row
        if row.get("regressed"):
            regressions.append(stream)
            M_SIM_REGRESSIONS.inc(stream=stream)

    doc: dict = {
        "kind": "plan-simulate-report", "version": 1,
        "trace": {
            "path": str(trace_path), "scenario": sched.scenario,
            "seed": sched.seed, "services": int(header["services"]),
            "nodes": int(header["nodes"]),
            "stages": int(header["stages"]),
            "recorded_digest": footer.get("digest"),
            "recorded_ok": footer.get("ok"),
        },
        "proposal": proposal,
        "events_digest": rep.digest(),
        "streams": streams,
        "regressions": regressions,
        "counters": {
            "baseline": footer.get("stats") or {},
            "proposed": dict(rep.stats),
        },
        "ok": rep.ok,
        "violations": list(rep.violations),
        "wall_streams": {
            "baseline": baseline_slo.get("wall") or {},
            "proposed": rep.slo.get("wall") or {},
        },
    }
    doc["digest"] = report_digest(doc)
    return doc
