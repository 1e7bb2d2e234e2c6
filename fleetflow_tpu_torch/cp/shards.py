"""Control-plane shard table: consistent-hash partitioning of agents (the
port's copy of ``fleetflow_tpu/cp/shards.py``).

One asyncio process terminates every agent session, and
at 10k agents the flat fan-out paths — registry command delivery, log
routing, failure-detector sweeps — are the throughput ceiling. This
module is the partitioning substrate they all share: a consistent-hash
ring mapping agent slug -> shard id, so each CP worker shard owns a
stable subset of the fleet (its registry partition, its command
pipeline lane, its log-routing lane, its verdict-coalescing bucket).

Consistent hashing (Karger et al., STOC '97) rather than `hash(slug) %
n` for two reasons that matter operationally:

  * stability under resize — changing `FLEET_CP_SHARDS` moves only
    ~1/n of the fleet's agents to new shards, so a resize on a live CP
    invalidates the minimum of shard-local state (pipeline lanes,
    coalesced verdict buckets), not the whole table;
  * determinism across processes — Python's builtin `hash()` is
    randomized per process (PYTHONHASHSEED), which would scatter agents
    differently on every CP restart and make chaos schedules
    unreplayable. The ring hashes with blake2b, stable everywhere.

Rebalancing needs NO new persistent state: the mapping is pure
(slug, shard_count) -> shard, so after a resize the new table is fully
determined by the already-journaled server/lease records — `resize()`
just recounts which live slugs moved and lets the owners (registry,
log router, detector) re-bucket lazily on next touch.

Tuning `FLEET_CP_SHARDS`: docs/guide/17-cp-sharding.md.
"""

from __future__ import annotations

import bisect
import hashlib
import os
from typing import Iterable, Optional

from ..obs import get_logger, kv
from ..obs.metrics import MS_BUCKETS, REGISTRY

log = get_logger("cp.shards")

__all__ = ["ShardTable", "DEFAULT_SHARDS", "shards_from_env"]

# Default worker-shard count. Sized for one CP process: shards are
# asyncio task lanes, not OS threads, so the sweet spot tracks the
# per-shard pipeline depth (see PER_SHARD_CONCURRENCY in
# agent_registry.py), not core count.
DEFAULT_SHARDS = 4

# virtual nodes per shard — enough that the largest shard carries at
# most a few percent more agents than the mean at 10k agents
VNODES = 64

# metric catalog: docs/guide/10-observability.md
_M_SHARD_AGENTS = REGISTRY.gauge(
    "fleet_cp_shard_agents",
    "Agents owned per CP worker shard (consistent-hash partition size)",
    labels=("shard",))
_M_FANOUT_MS = REGISTRY.histogram(
    "fleet_cp_shard_fanout_ms",
    "Per-shard command-batch pipeline wall ms (send_batch lanes)",
    labels=("shard",), buckets=MS_BUCKETS)
_M_REBALANCES = REGISTRY.counter(
    "fleet_cp_shard_rebalances_total",
    "Shard-table resizes (FLEET_CP_SHARDS changes); each moves ~1/n "
    "of the fleet's slugs")
_M_LOG_DROPPED = REGISTRY.counter(
    "fleet_cp_shard_log_dropped_total",
    "Log lines dropped from full subscriber lanes, by publisher shard",
    labels=("shard",))


def shards_from_env(default: int = DEFAULT_SHARDS) -> int:
    """Parse FLEET_CP_SHARDS; bad/absent values fall back to `default`.
    0 or 1 means unsharded (one lane owns everything)."""
    raw = os.environ.get("FLEET_CP_SHARDS", "")
    try:
        n = int(raw)
    except ValueError:
        return default
    return n if n >= 1 else default


def _hash64(key: str) -> int:
    # blake2b is the stdlib's fastest keyed-size hash; 8 bytes is plenty
    # of ring resolution for <=64 shards * 64 vnodes
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class ShardTable:
    """Immutable-feeling consistent-hash ring with in-place resize.

    Not thread-locked: mutation (`resize`) happens only from the CP's
    event loop / chaos runner; `shard_of` is a pure read over tuples,
    safe from executor threads mid-resize because the ring is swapped
    atomically (single attribute rebind).
    """

    def __init__(self, shards: Optional[int] = None):
        n = shards if shards is not None else shards_from_env()
        self._ring_keys: tuple[int, ...] = ()
        self._ring_vals: tuple[int, ...] = ()
        self.shards = 0
        self._build(max(1, n))

    def _build(self, n: int) -> None:
        points = []
        for shard in range(n):
            for v in range(VNODES):
                points.append((_hash64(f"shard-{shard}:vn-{v}"), shard))
        points.sort()
        self._ring_keys = tuple(p[0] for p in points)
        self._ring_vals = tuple(p[1] for p in points)
        self.shards = n

    # ------------------------------------------------------------------
    def shard_of(self, slug: str) -> int:
        """slug -> owning shard id (0..shards-1); pure and stable."""
        if self.shards <= 1:
            return 0
        i = bisect.bisect_right(self._ring_keys, _hash64(slug))
        if i == len(self._ring_keys):
            i = 0
        return self._ring_vals[i]

    def partition(self, slugs: Iterable[str]) -> dict[int, list[str]]:
        """Bucket slugs by owning shard (buckets keyed 0..shards-1, all
        present even when empty — callers iterate lanes, not agents)."""
        out: dict[int, list[str]] = {s: [] for s in range(self.shards)}
        for slug in slugs:
            out[self.shard_of(slug)].append(slug)
        return out

    def resize(self, n: int, live_slugs: Iterable[str] = ()) -> int:
        """Rebuild the ring for `n` shards; returns how many of
        `live_slugs` changed owner. No persistent state is touched —
        the live slugs come from the journaled server/lease tables and
        their new owners are recomputed lazily by each subsystem."""
        n = max(1, n)
        if n == self.shards:
            return 0
        slugs = list(live_slugs)
        before = {s: self.shard_of(s) for s in slugs}
        self._build(n)
        moved = sum(1 for s in slugs if self.shard_of(s) != before[s])
        _M_REBALANCES.inc()
        log.info("shard table resized %s", kv(
            shards=n, moved=moved, live=len(slugs)))
        return moved

    # ------------------------------------------------------------------
    # instrumentation hooks (shared by registry / log router / detector)
    # ------------------------------------------------------------------

    def observe_fanout_ms(self, shard: int, ms: float) -> None:
        _M_FANOUT_MS.observe(ms, shard=str(shard))

    def set_shard_agents(self, census: dict[int, int]) -> None:
        for shard in range(self.shards):
            _M_SHARD_AGENTS.set(census.get(shard, 0), shard=str(shard))

    def count_log_drop(self, shard: int) -> None:
        _M_LOG_DROPPED.inc(shard=str(shard))
