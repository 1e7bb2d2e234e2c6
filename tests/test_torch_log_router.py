"""The port's log router (fleetflow_tpu_torch.cp.log_router) against the
reference's (fleetflow_tpu.cp.log_router), on the CPU.

The lanes and backlog cases of tests/test_cp_sharding.py (a slow shard's
drops starve no other shard, per-lane capacity, the unsharded router's
single lane, async readers woken in publish order) and a seeded storm of
publishes over several subscribers, prefixes and levels, run on both
packages' LogRouter with the same shard table size: equal deliveries,
drain order, drop counts by shard, backlog census, retained tails and
topics (timestamps aside), and equal moves of the router's counters.
"""

from __future__ import annotations

import asyncio
import importlib
import random
from types import SimpleNamespace

import pytest

_MODS = dict(router="cp.log_router", shards="cp.shards",
             metrics="obs.metrics")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)

_COUNTERS = ("fleet_log_lines_published_total",
             "fleet_log_lines_delivered_total",
             "fleet_log_lines_dropped_total")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def _two_servers_on_different_shards(table):
    base = "sha"
    sa = table.shard_of(base)
    for i in range(1000):
        other = f"shb-{i}"
        if table.shard_of(other) != sa:
            return base, other
    raise AssertionError("no second shard found")


def _entry(e) -> tuple:
    return (e.topic, e.line, e.level)


def _drain(q) -> list:
    out = []
    while not q.empty():
        out.append(_entry(q.get_nowait()))
    return out


def _census(router, sids) -> dict:
    total, subs = router.backlog()
    return dict(
        backlog=(total, subs),
        dropped={sid: (router.subscriber(sid).dropped,
                       dict(router.subscriber(sid).dropped_by_shard))
                 for sid in sids},
        topics=router.topics(), all_topics=router.topics(prefix=""),
        retained={t: [_entry(e) for e in router.retained(t)]
                  for t in router.topics(prefix="")},
        tail={t: [_entry(e) for e in router.retained(t, limit=2)]
              for t in router.topics(prefix="")})


def _counter_moves(pkg, fn):
    reg = pkg.metrics.REGISTRY
    before = [reg.get(n).value() for n in _COUNTERS]
    out = fn()
    return out, [reg.get(n).value() - b for n, b in zip(_COUNTERS, before)]


def _slow_shard(pkg):
    async def go():
        table = pkg.shards.ShardTable(4)
        a, b = _two_servers_on_different_shards(table)
        router = pkg.router.LogRouter(queue_size=3, shard_table=table)
        sid, q = router.subscribe(prefix="logs/")
        for i in range(10):
            router.publish_line(a, "c", f"a{i}")
        for i in range(2):
            router.publish_line(b, "c", f"b{i}")
        census = _census(router, [sid])
        return census, q.qsize(), _drain(q)
    return run(go())


def _per_lane(pkg):
    async def go():
        table = pkg.shards.ShardTable(4)
        a, b = _two_servers_on_different_shards(table)
        router = pkg.router.LogRouter(queue_size=5, shard_table=table)
        sid, q = router.subscribe(prefix="logs/")
        for i in range(5):
            router.publish_line(a, "c", f"a{i}")
        for i in range(5):
            router.publish_line(b, "c", f"b{i}")
        return _census(router, [sid]), q.qsize(), _drain(q)
    return run(go())


def _unsharded(pkg):
    async def go():
        router = pkg.router.LogRouter(queue_size=4)
        sid, q = router.subscribe(prefix="logs/")
        for i in range(6):
            router.publish_line("s", "c", f"l{i}")
        return _census(router, [sid]), _drain(q)
    return run(go())


def _async_order(pkg):
    async def go():
        table = pkg.shards.ShardTable(4)
        a, b = _two_servers_on_different_shards(table)
        router = pkg.router.LogRouter(queue_size=10, shard_table=table)
        _, q = router.subscribe(prefix="logs/")

        async def drain(n):
            return [(await q.get()).line for _ in range(n)]

        reader = asyncio.ensure_future(drain(4))
        await asyncio.sleep(0.01)
        router.publish_line(a, "c", "a0")
        router.publish_line(b, "c", "b0")
        router.publish_line(a, "c", "a1")
        router.publish_line(b, "c", "b1")
        return await reader
    return run(go())


def _storm(pkg):
    """Seeded publishes from 12 servers over 4 shards into subscribers
    with different prefixes, levels and a small retain ring; one
    unsubscribes half way."""
    async def go():
        rng = random.Random(3)
        table = pkg.shards.ShardTable(4)
        router = pkg.router.LogRouter(retain=5, queue_size=6,
                                      shard_table=table)
        subs = [router.subscribe(prefix="logs/"),
                router.subscribe(prefix="logs/node003/"),
                router.subscribe(prefix="logs/", min_level="warn"),
                router.subscribe(prefix="logs/node01")]
        delivered = []
        for i in range(300):
            server = f"node{rng.randrange(12):03d}"
            level = rng.choice(("trace", "debug", "info", "warn", "error"))
            delivered.append(router.publish_line(
                server, rng.choice(("web", "db")), f"m{i}", level=level))
            if i == 150:
                router.unsubscribe(subs[3][0])
        census = _census(router, [s for s, _ in subs[:3]])
        return delivered, census, [_drain(q) for _, q in subs]
    return run(go())


CASES = {"slow_shard": _slow_shard, "per_lane_capacity": _per_lane,
         "unsharded": _unsharded, "async_publish_order": _async_order,
         "storm": _storm}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_router_equal(case):
    out = [_counter_moves(pkg, lambda pkg=pkg: CASES[case](pkg))
           for pkg in BOTH]
    assert out[0] == out[1]


def test_reference_expectations_hold_on_port():
    """The reference's own expectations, on the port's router."""
    census, qsize, drained = _slow_shard(PORT)
    ((sid, (dropped, by_shard)),) = census["dropped"].items()
    assert dropped == 7 and len(by_shard) == 1 and qsize == 5
    assert [d[1] for d in drained] == ["a7", "a8", "a9", "b0", "b1"]
    census, drained = _unsharded(PORT)
    assert [d[1] for d in drained] == ["l2", "l3", "l4", "l5"]
    assert _async_order(PORT) == ["a0", "b0", "a1", "b1"]


def test_entry_and_topic_equal():
    assert PORT.router.topic_for("n1", "web") == \
        REF.router.topic_for("n1", "web") == "logs/n1/web"
    assert PORT.router.RETAIN_LINES == REF.router.RETAIN_LINES
    e = PORT.router.LogEntry(topic="logs/a/b", line="x", level="warn",
                             ts=5.0)
    r = REF.router.LogEntry(topic="logs/a/b", line="x", level="warn",
                            ts=5.0)
    assert e.to_dict() == r.to_dict()
