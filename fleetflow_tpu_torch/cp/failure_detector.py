"""Lease-based failure detection: missed heartbeats become verdicts (the
port's copy of ``fleetflow_tpu/cp/failure_detector.py``).

The CP records every heartbeat (store.heartbeat, fleet_heartbeats_total)
but nothing ever turned a MISSED heartbeat into a node event — a killed
agent stranded its services until an operator called placement.node_event
by hand. This module is the missing half: each agent holds a lease renewed
by its heartbeats; an expired lease moves the agent through a
suspect -> dead state machine whose DEAD verdicts the reconverger
(cp/reconverge.py) turns into coalesced churn re-solves and redeploys.
Borg makes automatic re-placement after machine failure the defining
control-plane behavior (Verma et al., EuroSys '15 §3.1); crash-only design
(Candea & Fox, HotOS '03) wants recovery to be the normal code path — so
the detector is always on, cheap, and driven by the same sweep whether the
clock is wall time or the chaos harness's virtual clock.

State machine per agent:

    ALIVE --lease expired / disconnect--> SUSPECT
    SUSPECT --heartbeat--> ALIVE            (silent revive: no verdict)
    SUSPECT --grace expired--> DEAD         (verdict: reconverge)
    DEAD --heartbeat--> ALIVE               (verdict: node online, unpark)

Verdicts are only the DEAD and DEAD->ALIVE transitions — the expensive
ones, each costing a warm re-solve + redeploy fan-out. SUSPECT is free and
absorbs fast reconnects (an agent session bounce never reaches the solver).

Flap damping: a bouncing agent (crashlooping host, flapping link) would
otherwise emit a dead verdict per bounce and trigger a re-solve storm.
The detector counts verdicts per agent in a rolling window; past
`flap_threshold` the agent is DAMPED — further dead verdicts are held
until it has been continuously suspect for `damp_hold_s` (hysteresis: one
verdict per hold period at most). Revive verdicts are never held: retrying
parked work against a returned node is cheap and correct.

Thread-safe (heartbeats land on the asyncio loop; sweeps may run on
executor threads). The clock is injectable and MONOTONIC — wall-clock
jumps must not kill a fleet (time.monotonic in production, the chaos
VirtualClock in tests/scenarios).

Sweep cost: the sweep used to scan EVERY lease under the
lock on every tick — O(agents) per tick, and at 10k leases the scan
dominated the reconverge loop while holding the lock heartbeats need.
The default sweep now pops a min-expiry heap of attention times (lease
deadlines / suspect-grace expiries / damp-hold releases): a quiet fleet
costs O(expired · log n) per sweep, independent of fleet size.
Heartbeats invalidate LAZILY — renewing a lease just moves its
deadline; the stale heap entry pops at the old deadline, re-derives the
lease's real state, and re-schedules itself. Entry staleness is tracked
with per-lease generation counters; `use_heap=False` retains the full
scan, which doubles as the property-test oracle (the two sweeps must
emit identical verdict streams on any schedule) and the unsharded
baseline.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY

log = get_logger("cp.lease")

__all__ = ["LeaseConfig", "LeaseEvent", "FailureDetector",
           "ALIVE", "SUSPECT", "DEAD"]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

# metric catalog: docs/guide/10-observability.md
_M_TRANSITIONS = REGISTRY.counter(
    "fleet_lease_transitions_total",
    "Lease state-machine transitions, by target state", labels=("to",))
_M_AGENTS = REGISTRY.gauge(
    "fleet_lease_agents", "Agents tracked by the failure detector, by "
    "lease state", labels=("state",))
_M_DAMPED = REGISTRY.counter(
    "fleet_lease_flap_damped_total",
    "Dead verdicts deferred by flap damping (hysteresis holds)")


@dataclass
class LeaseConfig:
    """Tuning knobs (docs/guide/12-self-healing.md has the sizing math).

    `lease_s` should be >= 3x the agent heartbeat interval: one lost
    heartbeat must not start the clock toward a re-solve. The detection
    budget for a hard-killed node is lease_s + suspect_grace_s (a
    disconnect fast-paths to SUSPECT, so a crashed session pays only
    suspect_grace_s)."""
    lease_s: float = 90.0            # silence this long -> SUSPECT
    suspect_grace_s: float = 30.0    # suspect this long -> DEAD verdict
    flap_window_s: float = 600.0     # rolling window for verdict counting
    flap_threshold: int = 3          # >= verdicts in window -> damped
    damp_hold_s: float = 180.0       # damped: continuous-suspect hold


@dataclass
class LeaseEvent:
    """One verdict: `online=False` (DEAD) or `online=True` (revive).
    `at` is detector-clock time; `state` the new lease state."""
    slug: str
    online: bool
    at: float
    state: str


@dataclass
class _Lease:
    deadline: float = 0.0            # heartbeat lease expiry
    state: str = ALIVE
    suspect_since: float = 0.0
    connected: bool = True
    # verdict timestamps (dead + revive) for flap counting
    verdicts: deque = field(default_factory=lambda: deque(maxlen=32))
    damped_logged: bool = False      # one damped log/metric per hold
    # generation of this lease's live min-expiry-heap entry; -1 = no
    # timed attention scheduled (DEAD leases wait on a heartbeat, not
    # the clock). A popped entry with a stale generation is discarded.
    gen: int = -1


class FailureDetector:
    def __init__(self, config: Optional[LeaseConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 use_heap: bool = True):
        self.config = config or LeaseConfig()
        self.clock = clock
        self.use_heap = use_heap
        self._lock = threading.Lock()
        self._leases: dict[str, _Lease] = {}
        self._pending: list[LeaseEvent] = []   # revives awaiting a sweep
        # min-expiry heap of (attention_time, slug, generation)
        self._heap: list[tuple[float, str, int]] = []
        self._gen = 0
        # incremental per-state census (the fleet_lease_agents gauge
        # without an O(agents) recount per sweep)
        self._counts = {ALIVE: 0, SUSPECT: 0, DEAD: 0}

    # ------------------------------------------------------------------
    # observations (called from the agent channel / registry paths)
    # ------------------------------------------------------------------

    def _schedule(self, slug: str, lease: _Lease, at: float) -> None:
        """(Re)arm the lease's heap entry; any previous entry for the
        slug goes stale (generation mismatch) and is dropped on pop."""
        if not self.use_heap:
            return
        self._gen += 1
        lease.gen = self._gen
        heapq.heappush(self._heap, (at, slug, self._gen))

    def observe_heartbeat(self, slug: str) -> None:
        """Renew the lease. A heartbeat from a SUSPECT agent revives it
        silently; from a DEAD one it queues a node-online verdict (the
        reconverger retries parked work against returned capacity).

        Heap note: renewing an ALIVE lease does NOT touch the heap (the
        10k-agents-heartbeating hot path) — the entry at the old
        deadline lazily re-derives and re-arms itself when it pops."""
        now = self.clock()
        with self._lock:
            lease = self._leases.get(slug)
            if lease is None:
                lease = self._leases[slug] = _Lease()
                self._counts[ALIVE] += 1
                _M_TRANSITIONS.inc(to=ALIVE)
            lease.deadline = now + self.config.lease_s
            lease.connected = True
            if lease.gen == -1:
                # fresh lease, or revive of a DEAD one (no timed
                # attention while dead): arm the expiry timer
                self._schedule(slug, lease, lease.deadline)
            if lease.state == ALIVE:
                return
            was = lease.state
            lease.state = ALIVE
            lease.damped_logged = False
            self._counts[was] -= 1
            self._counts[ALIVE] += 1
            _M_TRANSITIONS.inc(to=ALIVE)
            log.info("agent revived %s", kv(slug=slug, was=was))
            if was == DEAD:
                lease.verdicts.append(now)
                self._pending.append(LeaseEvent(slug, True, now, ALIVE))

    def prime(self, slug: str) -> None:
        """Start tracking a known-but-not-yet-heard-from agent: the lease
        clock starts NOW without a heartbeat. Called at CP boot and on
        standby promotion for every server record that was online — a
        node that died together with (or during the absence of) the old
        primary never heartbeats the new one, so without priming its
        death would be invisible forever. A live agent's first heartbeat
        simply renews the primed lease; a dead one expires through the
        normal SUSPECT -> DEAD path and gets its verdict."""
        now = self.clock()
        with self._lock:
            if slug in self._leases:
                return
            lease = self._leases[slug] = _Lease()
            lease.deadline = now + self.config.lease_s
            lease.connected = False
            self._counts[ALIVE] += 1
            self._schedule(slug, lease, lease.deadline)
            _M_TRANSITIONS.inc(to=ALIVE)
            log.debug("lease primed %s", kv(slug=slug,
                                            lease_s=self.config.lease_s))

    def observe_disconnect(self, slug: str) -> None:
        """Session gone: fast-path ALIVE -> SUSPECT (the lease no longer
        means anything — its renewals came over the dead session). A fast
        reconnect re-heartbeats within the grace and nothing fires."""
        now = self.clock()
        with self._lock:
            lease = self._leases.get(slug)
            if lease is None:
                return
            lease.connected = False
            if lease.state == ALIVE:
                lease.state = SUSPECT
                lease.suspect_since = now
                self._counts[ALIVE] -= 1
                self._counts[SUSPECT] += 1
                # the fast path moves attention EARLIER than the armed
                # lease deadline: re-arm at the grace expiry
                self._schedule(slug, lease,
                               now + self.config.suspect_grace_s)
                _M_TRANSITIONS.inc(to=SUSPECT)
                log.debug("agent suspect %s", kv(slug=slug,
                                                 reason="disconnect"))

    def forget(self, slug: str) -> None:
        """Server deleted/deprovisioned: stop tracking (no verdict — the
        operator path already ran its own node_event)."""
        with self._lock:
            lease = self._leases.pop(slug, None)
            if lease is not None:
                self._counts[lease.state] -= 1

    # ------------------------------------------------------------------
    # the sweep (called by the reconverger loop / chaos runner)
    # ------------------------------------------------------------------

    def _flapping(self, lease: _Lease, now: float) -> bool:
        cutoff = now - self.config.flap_window_s
        return sum(1 for t in lease.verdicts
                   if t > cutoff) >= self.config.flap_threshold

    def sweep(self) -> list[LeaseEvent]:
        """Advance the leases against the clock; return the verdicts
        (DEAD + queued revives) since the last sweep, sorted by slug for
        deterministic replay.

        Two equivalent engines behind one contract (their verdict
        streams are property-tested identical on seeded schedules):
        the default expiry heap touches only due leases — O(expired ·
        log n); `use_heap=False` scans the full table — O(agents) — and
        serves as oracle and baseline."""
        now = self.clock()
        with self._lock:
            out, self._pending = self._pending, []
            if self.use_heap:
                self._sweep_heap(now, out)
            else:
                self._sweep_scan(now, out)
            for state, n in self._counts.items():
                _M_AGENTS.set(n, state=state)
        out.sort(key=lambda e: e.slug)
        return out

    def _sweep_scan(self, now: float, out: list[LeaseEvent]) -> None:
        """The original full-table sweep (lock held by caller)."""
        for slug in sorted(self._leases):
            self._advance(slug, self._leases[slug], now, out)

    def _sweep_heap(self, now: float, out: list[LeaseEvent]) -> None:
        """Pop only the leases whose attention time has arrived (lock
        held by caller). Stale entries (generation mismatch after a
        disconnect re-arm, or a forgotten slug) are discarded; live ones
        re-derive the lease's true condition at `now` — a heartbeat that
        moved the deadline since the entry was pushed simply re-arms at
        the new deadline (lazy invalidation)."""
        repush: list[tuple[float, str, int]] = []
        while self._heap and self._heap[0][0] <= now:
            _, slug, gen = heapq.heappop(self._heap)
            lease = self._leases.get(slug)
            if lease is None or lease.gen != gen:
                continue
            lease.gen = -1
            nxt = self._advance(slug, lease, now, out)
            if nxt is not None:
                # defer the push: an entry at exactly `now` must wait
                # for the NEXT sweep, not loop inside this one
                self._gen += 1
                lease.gen = self._gen
                repush.append((nxt, slug, self._gen))
        for entry in repush:
            heapq.heappush(self._heap, entry)
        if len(self._heap) > max(64, 4 * len(self._leases)):
            self._compact()

    def _advance(self, slug: str, lease: _Lease, now: float,
                 out: list[LeaseEvent]) -> Optional[float]:
        """Advance ONE lease's state machine to `now`; returns when it
        next needs clock attention (None: only a heartbeat can move it).
        This is the single transition body both sweep engines share, so
        they cannot drift."""
        cfg = self.config
        if lease.state == ALIVE:
            if not now > lease.deadline:
                return lease.deadline
            lease.state = SUSPECT
            lease.suspect_since = now
            self._counts[ALIVE] -= 1
            self._counts[SUSPECT] += 1
            _M_TRANSITIONS.inc(to=SUSPECT)
            log.info("agent suspect %s", kv(
                slug=slug, reason="lease-expired", lease_s=cfg.lease_s))
        if lease.state != SUSPECT:
            return None               # DEAD: waits on a heartbeat
        suspect_for = now - lease.suspect_since
        if suspect_for < cfg.suspect_grace_s:
            return lease.suspect_since + cfg.suspect_grace_s
        if self._flapping(lease, now) and suspect_for < cfg.damp_hold_s:
            if not lease.damped_logged:
                lease.damped_logged = True
                _M_DAMPED.inc()
                log.warning("dead verdict damped %s", kv(
                    slug=slug, hold_s=cfg.damp_hold_s,
                    window_s=cfg.flap_window_s))
            # earliest possible flip: the hold expires, or enough
            # verdicts age out of the flap window — whichever is first
            vs = list(lease.verdicts)
            unflap_at = vs[-cfg.flap_threshold] + cfg.flap_window_s
            return min(lease.suspect_since + cfg.damp_hold_s, unflap_at)
        lease.state = DEAD
        lease.damped_logged = False
        lease.verdicts.append(now)
        self._counts[SUSPECT] -= 1
        self._counts[DEAD] += 1
        _M_TRANSITIONS.inc(to=DEAD)
        log.warning("agent dead %s", kv(
            slug=slug, suspect_for_s=round(suspect_for, 1)))
        out.append(LeaseEvent(slug, False, now, DEAD))
        return None

    def _compact(self) -> None:
        """Rebuild the heap with one entry per timed lease, shedding the
        stale-generation residue disconnect re-arms leave behind. The
        rebuilt times are safe LOWER bounds (an early pop just
        re-derives and re-arms)."""
        self._heap = []
        for slug, lease in self._leases.items():
            if lease.gen == -1:
                continue
            at = (lease.deadline if lease.state == ALIVE
                  else lease.suspect_since + self.config.suspect_grace_s)
            self._gen += 1
            lease.gen = self._gen
            self._heap.append((at, slug, self._gen))
        heapq.heapify(self._heap)

    def requeue(self, events: list[LeaseEvent]) -> None:
        """The reconverger failed to process these verdicts (e.g. the
        re-solve burst crashed): put them back so the next sweep hands
        them out again — a verdict must never be silently lost."""
        with self._lock:
            self._pending.extend(events)

    # ------------------------------------------------------------------
    # introspection (fleet cp heal status)
    # ------------------------------------------------------------------

    def state_of(self, slug: str) -> Optional[str]:
        with self._lock:
            lease = self._leases.get(slug)
            return lease.state if lease else None

    def status(self) -> dict:
        now = self.clock()
        with self._lock:
            agents = {}
            for slug in sorted(self._leases):
                lease = self._leases[slug]
                agents[slug] = {
                    "state": lease.state,
                    "connected": lease.connected,
                    "lease_remaining_s": round(lease.deadline - now, 3),
                    "recent_verdicts": len(lease.verdicts),
                    "damped": (lease.state == SUSPECT
                               and self._flapping(lease, now)),
                }
            return {"config": {
                        "lease_s": self.config.lease_s,
                        "suspect_grace_s": self.config.suspect_grace_s,
                        "flap_window_s": self.config.flap_window_s,
                        "flap_threshold": self.config.flap_threshold,
                        "damp_hold_s": self.config.damp_hold_s},
                    "agents": agents}
