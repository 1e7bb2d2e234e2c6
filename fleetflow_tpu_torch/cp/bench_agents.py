"""10k-agent control-plane fan-out scenario (the port's copy of
``fleetflow_tpu/cp/bench_agents.py``).

Simulates a fleet of agents against a REAL AgentRegistry + FailureDetector
(no solver, no sockets): each simulated agent acks a command after a small
wire latency (loop.call_later), so the measured quantity is the CP-side
delivery machinery — task scheduling, correlation futures, shard pipeline
lanes — under a realistic ack delay, not localhost TCP noise.

Three measured legs, each sharded-vs-unsharded:

  * fanout — registry command fan-out to every agent. The unsharded
    baseline is the serial one-await-per-command loop (the reference's
    sequential per-service round-trip, engine.rs:157-167); the sharded number
    is `send_batch` pipelining PER_SHARD_CONCURRENCY commands per shard
    lane. Reported as p50/p99 wall ms over rounds + sends/s throughput.
  * redeliver — the same fan-out with deploy.execute-shaped payloads (the
    reconverger's redelivery storm after a node death).
  * sweep — FailureDetector sweep cost at N and 10N leases with a FIXED
    expired count: the scan engine (use_heap=False) pays O(agents) per
    sweep, the heap engine O(expired) — the 10N/N cost ratio is the
    sublinearity evidence, and both engines must emit identical verdicts
    on the same expiry schedule.

BENCH_AGENTS_ASSERT=1 turns the scenario's contract into hard failures:
sharded fan-out/redelivery throughput >= 5x serial at 10k agents (2x at
BENCH_SMALL scale, where fixed per-round overhead is a larger slice),
send_batch metric coalescing held (label lookups < items), heap sweep
cost sublinear in fleet size, and verdict parity between sweep engines.

Knobs: BENCH_AGENTS_WIRE_MS (simulated ack latency, default 0.2),
BENCH_AGENTS_ROUNDS (batched rounds, default 5), FLEET_CP_SHARDS.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sys
import time
from typing import Optional

from .agent_registry import AgentRegistry
from .failure_detector import DEAD, FailureDetector, LeaseConfig
from .shards import ShardTable, shards_from_env

__all__ = ["agents_scenario"]


class _SimAgentConn:
    """A simulated agent session: every command envelope is acked
    `wire_s` later via the registry's normal command_result correlation
    path (resolve_result), so the future plumbing under test is exactly
    production's."""

    def __init__(self, registry: AgentRegistry, wire_s: float):
        self._registry = registry
        self._wire_s = wire_s
        self._closed = False

    async def send_event(self, channel: str, method: str,
                         payload: Optional[dict] = None) -> None:
        rid = (payload or {}).get("request_id")
        if rid is None:
            return
        asyncio.get_running_loop().call_later(
            self._wire_s, self._registry.resolve_result, rid,
            {"result": {"ok": True}})


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, int(round(q / 100.0 * (len(ys) - 1))))
    return ys[i]


async def _fanout_leg(n_agents: int, shards: int, wire_s: float,
                      rounds: int, payload: Optional[dict],
                      serial_sample: int) -> dict:
    registry = AgentRegistry(shard_table=ShardTable(shards))
    slugs = [f"sim-{i:05d}" for i in range(n_agents)]
    for slug in slugs:
        registry.register(slug, _SimAgentConn(registry, wire_s))

    # serial baseline over a sample (throughput is per-item, so a sample
    # measures it; the full serial loop at 10k x wire would dominate the
    # scenario's wall time for no extra information)
    sample = slugs[:serial_sample]
    t0 = time.perf_counter()
    for slug in sample:
        await registry.send_command(slug, "bench.ping", payload, timeout=30)
    serial_s = time.perf_counter() - t0
    serial_rate = len(sample) / serial_s

    items = [(slug, "bench.ping", payload) for slug in slugs]
    round_ms: list[float] = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        results = await registry.send_batch(items, timeout=30)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        errs = sum(1 for r in results if isinstance(r, BaseException))
        assert errs == 0, f"{errs} batch sends failed"
    p50 = _pct(round_ms, 50)
    stats = dict(registry.last_batch_stats)
    return {
        "agents": n_agents,
        "shards": shards,
        "serial_sample": len(sample),
        "serial_rate_per_s": round(serial_rate, 1),
        "serial_extrapolated_ms": round(n_agents / serial_rate * 1e3, 1),
        "batch_rounds": rounds,
        "batch_p50_ms": round(p50, 1),
        "batch_p99_ms": round(_pct(round_ms, 99), 1),
        "batch_rate_per_s": round(n_agents / (p50 / 1e3), 1),
        "speedup_vs_serial": round((n_agents / (p50 / 1e3)) / serial_rate,
                                   1),
        "last_batch_stats": stats,
        "round_ms": [round(x, 1) for x in round_ms],
    }


def _sweep_leg(n: int, expired: int) -> dict:
    """Sweep cost scan-vs-heap at `n` and 10*`n` leases, fixed `expired`
    count. The steady-state sweep (nothing due) is the cost that runs
    every reconverge tick — scan pays the full-table walk there, heap
    pays only the pop-nothing check — and the expiry batch pins verdict
    parity between the engines."""
    cfg = LeaseConfig(lease_s=90.0, suspect_grace_s=30.0)
    iters = 10

    def build(n_leases: int, use_heap: bool):
        box = [1000.0]
        det = FailureDetector(cfg, clock=lambda: box[0], use_heap=use_heap)
        for i in range(n_leases):
            det.observe_heartbeat(f"lease-{i:06d}")
        det.sweep()
        return det, box

    def steady_ms(det) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            det.sweep()
        return (time.perf_counter() - t0) * 1e3 / iters

    out: dict = {"leases": n, "expired": expired, "engines": {}}
    verdicts: dict[str, list[str]] = {}
    for use_heap in (False, True):
        name = "heap" if use_heap else "scan"
        det, box = build(n, use_heap)
        at_n = steady_ms(det)
        # expire a fixed batch: disconnect -> grace elapses -> DEAD
        for i in range(expired):
            det.observe_disconnect(f"lease-{i:06d}")
        box[0] += cfg.suspect_grace_s + 1
        t0 = time.perf_counter()
        evs = det.sweep()
        expiry_ms = (time.perf_counter() - t0) * 1e3
        verdicts[name] = sorted(e.slug for e in evs if e.state == DEAD)
        det10, _ = build(10 * n, use_heap)
        at_10n = steady_ms(det10)
        out["engines"][name] = {
            "steady_ms_at_n": round(at_n, 3),
            "steady_ms_at_10n": round(at_10n, 3),
            "scale_10n_over_n": round(at_10n / max(at_n, 1e-6), 2),
            "expiry_batch_ms": round(expiry_ms, 3),
            "expiry_verdicts": len(verdicts[name]),
        }
    out["verdict_parity"] = verdicts["scan"] == verdicts["heap"]
    return out


async def _run(small: bool) -> dict:
    n_agents = 1000 if small else 10000
    shards = shards_from_env()
    wire_s = float(os.environ.get("BENCH_AGENTS_WIRE_MS", "0.2")) / 1e3
    rounds = int(os.environ.get("BENCH_AGENTS_ROUNDS", "5"))
    serial_sample = min(n_agents, 1000 if small else 2000)
    deploy_payload = {
        "request": {"fleet": "bench", "stage": "prod", "services": 3,
                    "idempotency_key": "bench-redeliver"},
        "assignment": {"svc-a": "n1", "svc-b": "n2", "svc-c": "n3"},
    }
    fanout = await _fanout_leg(n_agents, shards, wire_s, rounds,
                               None, serial_sample)
    redeliver = await _fanout_leg(n_agents, shards, wire_s, rounds,
                                  deploy_payload, serial_sample)
    return {"agents": n_agents, "shards": shards,
            "wire_ms": wire_s * 1e3,
            "fanout": fanout, "redeliver": redeliver}


def agents_scenario(small: bool) -> dict:
    """Run the three legs (1,000 agents when `small`, else 10,000) and
    return their numbers; BENCH_AGENTS_ASSERT=1 exits 1 on a breach."""
    # the expiry batch transitions log at info/warning; the scenario must
    # not spray hundreds of lease lines to stderr
    lease_log = logging.getLogger("fleetflow.cp.lease")
    prev_level = lease_log.level
    lease_log.setLevel(logging.ERROR)
    try:
        out = asyncio.run(_run(small))
        out["sweep"] = _sweep_leg(n=1000 if small else 10000,
                                  expired=50)
    finally:
        lease_log.setLevel(prev_level)
    if os.environ.get("BENCH_AGENTS_ASSERT", "").lower() in \
            ("1", "true", "on", "yes"):
        _assert_agents(out, small)
    return out


def _assert_agents(out: dict, small: bool) -> None:
    """BENCH_AGENTS_ASSERT=1: the scenario's contract."""
    need = 2.0 if small else 5.0
    breaches = []
    for leg in ("fanout", "redeliver"):
        r = out[leg]
        if r["speedup_vs_serial"] < need:
            breaches.append(
                f"{leg}: sharded batch {r['batch_rate_per_s']:.0f}/s is "
                f"only {r['speedup_vs_serial']:.1f}x the serial baseline "
                f"{r['serial_rate_per_s']:.0f}/s (need >= {need:.0f}x)")
        stats = r["last_batch_stats"]
        if not (0 < stats["label_lookups"] < stats["items"]):
            breaches.append(
                f"{leg}: per-command metric lookups not coalesced "
                f"({stats['label_lookups']} lookups for "
                f"{stats['items']} items)")
        if stats["epoch_lookups"] > 1:
            breaches.append(f"{leg}: fencing epoch resolved "
                            f"{stats['epoch_lookups']}x per batch")
    sweep = out["sweep"]
    heap = sweep["engines"]["heap"]
    scan = sweep["engines"]["scan"]
    # sublinear: 10x the fleet must NOT cost ~10x the sweep. Slack for
    # timer noise on the sub-ms heap sweeps.
    if heap["steady_ms_at_10n"] > 3 * heap["steady_ms_at_n"] + 0.5:
        breaches.append(
            f"heap sweep not sublinear: {heap['steady_ms_at_n']:.3f} ms "
            f"at n -> {heap['steady_ms_at_10n']:.3f} ms at 10n")
    if heap["steady_ms_at_10n"] > scan["steady_ms_at_10n"]:
        breaches.append(
            f"heap sweep ({heap['steady_ms_at_10n']:.3f} ms) no cheaper "
            f"than scan ({scan['steady_ms_at_10n']:.3f} ms) at 10n")
    if not sweep["verdict_parity"]:
        breaches.append("scan and heap sweeps emitted different verdict "
                        "sets on the same expiry schedule")
    if heap["expiry_verdicts"] != sweep["expired"]:
        breaches.append(
            f"heap sweep emitted {heap['expiry_verdicts']} verdicts for "
            f"{sweep['expired']} expired leases")
    if breaches:
        print(json.dumps({"agents_assert": "FAIL", "breaches": breaches}),
              file=sys.stderr, flush=True)
        sys.exit(1)
