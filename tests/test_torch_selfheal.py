"""The port's self-healing path (fleetflow_tpu_torch.cp: the failure
detector, the shard table, the agent registry, the wire protocol and the
reconverger) against the reference's (fleetflow_tpu.cp), on the CPU.

- the detector: the reference's lease timelines (tests/test_selfheal.py)
  run on both packages' FailureDetector on one fake clock, event for event
  and state for state, and the heap sweep against the scan oracle on
  seeded random schedules (tests/test_cp_sharding.py), across packages;
- the shard table: the same owner for 10,000 slugs and the same moves on
  a resize;
- the registry: the structured errors (retryable AgentUnreachable, fatal
  AgentCommandFailed) and send_batch's alignment, coalescing and
  disconnect fast-fail, equal;
- the protocol: ``encode_frame`` byte-equal, and a loopback round trip
  between each package's ProtocolServer and each one's ProtocolClient;
- the reconverger: every case of the reference's TestReconverger with the
  same fakes and ``rng=Random(0)``: equal summaries, stats, backoff
  delays and ParkedWork records; each package's store reads the parked
  work the other's journaled;
- device faults: a ``node_events`` that raises a fault of the device path
  (``KernelError``, ``torch.OutOfMemoryError``, or an error raised from
  one) requeues the verdicts and ends ``run_loop`` with that fault; any
  other error is logged and the loop goes on;
- end to end, at small size (a fleetgen fleet of ~60 services on 12
  servers): chip_smoke's ``[heal]`` phase with the card scheduler on the
  CPU (``PlacementService(store, device="cpu")``) heals one killed node,
  then three, and holds the phase's contract; the same drive on both
  packages' host path (the reference's default, the port's
  ``use_gpu=False``) is equal step by step: summaries, assignments,
  Deployment records and backend states.

The reference's reconverger runs on its server's AppState; the port's on
any holder of the three attributes it reads (its ``HealState``: the port's
``AppState`` is one, these cases hold them in a SimpleNamespace).
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_cp_sharding as ref_sharding_tests
import test_selfheal as ref_heal_tests
from fleetflow_tpu.cp.server import AppState

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_MODS = dict(fd="cp.failure_detector", reg="cp.agent_registry",
             shards="cp.shards", protocol="cp.protocol", rc="cp.reconverge",
             models="cp.models", store="cp.store", placement="cp.placement",
             errors="core.errors", base="sched.base", model="core.model",
             serialize="core.serialize", parser="core.parser",
             fleetgen="lower.fleetgen", metrics="obs.metrics",
             trace="obs.trace")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t


def _err(e) -> tuple:
    """An exception as the fields a caller branches on."""
    return (type(e).__name__, getattr(e, "reason", None),
            getattr(e, "retryable", None), str(e))


# --------------------------------------------------------------------------
# the failure detector
# --------------------------------------------------------------------------

DET_CFG = dict(lease_s=10.0, suspect_grace_s=5.0, flap_window_s=100.0,
               flap_threshold=3, damp_hold_s=30.0)
FLAP_OPS = [("hb", "a", 0.0), ("disc", "a", 1.0), ("sweep", 7.0),
            ("hb", "a", 8.0), ("sweep", 8.0), ("disc", "a", 9.0),
            ("sweep", 15.0), ("hb", "a", 16.0), ("sweep", 16.0),
            ("disc", "a", 17.0), ("sweep", 23.0), ("sweep", 30.0),
            ("sweep", 47.5)]
OTHER_OPS = {
    "flap_damping": FLAP_OPS,
    "forget": [("hb", "a", 0.0), ("hb", "b", 0.0), ("forget", "a", 1.0),
               ("sweep", 100.0)],
    "requeue": [("hb", "a", 0.0), ("sweep", 11.0), ("sweep", 17.0),
                ("requeue", "a", 17.0), ("sweep", 17.0)],
    "prime_then_expire": [("prime", "a", 0.0), ("prime", "b", 0.0),
                          ("hb", "b", 5.0), ("sweep", 11.0),
                          ("sweep", 16.5), ("sweep", 21.0)],
    "revive_dead_primed": [("prime", "a", 0.0), ("sweep", 10.5),
                           ("sweep", 16.0), ("hb", "a", 17.0),
                           ("sweep", 17.0)],
}


def _drive_detector(P, ops, **cfg):
    """Run a timeline of ops on package P's detector; return each op's
    verdicts, every slug's state after it, and the final status."""
    clock = FakeClock()
    det = P.fd.FailureDetector(P.fd.LeaseConfig(**dict(DET_CFG, **cfg)),
                               clock=clock.now)
    slugs = sorted({op[1] for op in ops if isinstance(op[1], str)})
    out, last = [], []
    for op in ops:
        kind = op[0]
        if kind == "sweep":
            clock.t = op[1]
            last = det.sweep()
            got = [(e.slug, e.online, e.at, e.state) for e in last]
        else:
            slug, clock.t = op[1], op[2]
            if kind == "requeue":
                det.requeue(last)
            else:
                getattr(det, {"hb": "observe_heartbeat",
                              "disc": "observe_disconnect",
                              "prime": "prime", "forget": "forget"}[kind])(
                    slug)
            got = None
        out.append((op, got, [det.state_of(s) for s in slugs]))
    return out, det.status()


class TestDetector:
    @pytest.mark.parametrize(
        "name,ops", ref_heal_tests.TestLeaseStateMachine.CASES,
        ids=[c[0] for c in ref_heal_tests.TestLeaseStateMachine.CASES])
    def test_reference_timelines_equal(self, name, ops):
        ref, port = (_drive_detector(P, ops) for P in BOTH)
        assert port == ref
        # and each sweep hands out what the reference test expects
        for op, got, _ in port[0]:
            if op[0] == "sweep":
                assert [(s, on) for s, on, _, _ in got] == op[2], name

    @pytest.mark.parametrize("name", sorted(OTHER_OPS))
    def test_timelines_equal(self, name):
        ref, port = (_drive_detector(P, OTHER_OPS[name]) for P in BOTH)
        assert port == ref
        if name == "flap_damping":
            # the third death of a flapping agent is held, then released
            sweeps = [got for op, got, _ in port[0] if op[0] == "sweep"]
            assert sweeps[-2] == [] and sweeps[-1][0][:2] == ("a", False)

    def test_damped_metric_moves_alike(self):
        moved = []
        for P in BOTH:
            m = P.metrics.REGISTRY.get("fleet_lease_flap_damped_total")
            before = m.value()
            _drive_detector(P, FLAP_OPS)
            moved.append(m.value() - before)
        assert moved == [1.0, 1.0]

    @pytest.mark.parametrize("seed", range(8))
    def test_heap_and_scan_streams_equal_across_packages(self, seed):
        """The reference's property test schedule (test_cp_sharding.py):
        both packages' heap sweeps and the port's scan oracle emit the
        same verdict stream and leave every lease in the same state."""
        cfg = ref_sharding_tests._CFG
        box = [1000.0]
        dets = [P.fd.FailureDetector(P.fd.LeaseConfig(
                    **dataclasses.asdict(cfg)), clock=lambda: box[0],
                    use_heap=heap)
                for P, heap in ((REF, True), (PORT, True), (PORT, False))]
        rng = random.Random(seed)
        slugs = [f"n{i}" for i in range(30)]
        streams: list = [[], [], []]
        key = ref_sharding_tests._event_key
        for _ in range(400):
            op = rng.random()
            if op < 0.35:
                s = rng.choice(slugs)
                for d in dets:
                    d.observe_heartbeat(s)
            elif op < 0.55:
                s = rng.choice(slugs)
                for d in dets:
                    d.observe_disconnect(s)
            elif op < 0.58:
                s = rng.choice(slugs)
                for d in dets:
                    d.forget(s)
            elif op < 0.65:
                box[0] += rng.uniform(0.0, 30.0)
            else:
                box[0] += rng.uniform(0.0, 4.0)
                for out, d in zip(streams, dets):
                    out.extend(map(key, d.sweep()))
        for _ in range(12):
            box[0] += 30.0
            for out, d in zip(streams, dets):
                out.extend(map(key, d.sweep()))
        assert streams[1] == streams[0] == streams[2]
        assert streams[0]
        for s in slugs:
            assert len({d.state_of(s) for d in dets}) == 1

    def test_alive_heartbeats_do_not_grow_heap(self):
        box = [0.0]
        det = PORT.fd.FailureDetector(ref_sharding_tests._CFG,
                                      clock=lambda: box[0])
        for i in range(50):
            det.observe_heartbeat(f"n{i}")
        size0 = len(det._heap)
        for _ in range(100):
            box[0] += 1.0
            for i in range(50):
                det.observe_heartbeat(f"n{i}")
        assert len(det._heap) == size0

    def test_heap_compacts_alike(self):
        sizes = []
        for P in BOTH:
            box = [0.0]
            det = P.fd.FailureDetector(ref_sharding_tests._CFG,
                                       clock=lambda: box[0])
            for i in range(50):
                det.observe_heartbeat(f"n{i}")
            for _ in range(20):
                for i in range(50):
                    det.observe_disconnect(f"n{i}")
                    det.observe_heartbeat(f"n{i}")
            det.sweep()
            sizes.append(len(det._heap))
        assert sizes[0] == sizes[1] <= max(64, 4 * 50)

    def test_lease_agents_gauge_alike(self):
        out = []
        for P in BOTH:
            _drive_detector(P, OTHER_OPS["prime_then_expire"])
            g = P.metrics.REGISTRY.get("fleet_lease_agents")
            out.append([g.value(state=s) for s in ("alive", "suspect",
                                                   "dead")])
        assert out[1] == out[0]


# --------------------------------------------------------------------------
# the shard table
# --------------------------------------------------------------------------

class TestShards:
    @pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
    def test_owners_equal_for_10k_slugs(self, n):
        slugs = [f"srv-{i:05d}" for i in range(10_000)]
        ref, port = (P.shards.ShardTable(n) for P in BOTH)
        assert [port.shard_of(s) for s in slugs] == \
            [ref.shard_of(s) for s in slugs]
        assert port.partition(slugs[:100]) == ref.partition(slugs[:100])

    @pytest.mark.parametrize("path", [(4, 5), (5, 3), (8, 16), (4, 4),
                                      (1, 4)])
    def test_resize_moves_equal(self, path):
        slugs = [f"node-{i}" for i in range(2000)]
        out = []
        for P in BOTH:
            t = P.shards.ShardTable(path[0])
            moved = t.resize(path[1], slugs)
            out.append((moved, [t.shard_of(s) for s in slugs]))
        assert out[1] == out[0]

    @pytest.mark.parametrize("raw", [None, "8", "garbage", "0", "1", "-3"])
    def test_env_parsing_equal(self, raw, monkeypatch):
        if raw is None:
            monkeypatch.delenv("FLEET_CP_SHARDS", raising=False)
        else:
            monkeypatch.setenv("FLEET_CP_SHARDS", raw)
        assert PORT.shards.shards_from_env() == REF.shards.shards_from_env()
        assert PORT.shards.ShardTable().shards == REF.shards.ShardTable().shards


# --------------------------------------------------------------------------
# the agent registry
# --------------------------------------------------------------------------

class NeverConn:
    """Swallows every send: the command's future never resolves."""
    _closed = False
    identity = "x"

    async def send_event(self, channel, method, payload):
        pass


class AckConn:
    """Acks every command after `delay` through the correlation path."""

    def __init__(self, registry, delay=0.0, error=None):
        self.registry, self.delay, self.error = registry, delay, error
        self.envelopes = []
        self._closed = False

    async def send_event(self, channel, method, payload=None):
        env = payload or {}
        self.envelopes.append((method, env))
        rid = env.get("request_id")
        reply = ({"error": self.error} if self.error
                 else {"result": {"ok": True, "cmd": method}})
        if rid:
            asyncio.get_running_loop().call_later(
                self.delay, self.registry.resolve_result, rid, reply)


async def _not_connected(P):
    reg = P.reg.AgentRegistry()
    await reg.send_command("ghost", "ping", {})


async def _timeout(P):
    reg = P.reg.AgentRegistry()
    reg.register("n1", NeverConn())
    await reg.send_command("n1", "ping", {}, timeout=0.05)


async def _agent_error(P):
    reg = P.reg.AgentRegistry()
    reg.register("n1", AckConn(reg, error="deploy exploded"))
    await reg.send_command("n1", "deploy.execute", {})


async def _disconnect(P):
    reg = P.reg.AgentRegistry()
    conn = NeverConn()
    reg.register("n1", conn)

    async def killer():
        await asyncio.sleep(0.02)
        reg.unregister("n1", conn)

    k = asyncio.ensure_future(killer())
    try:
        await reg.send_command("n1", "ping", {}, timeout=5)
    finally:
        await k


async def _delivery_hook(P):
    reg = P.reg.AgentRegistry()
    reg.register("n1", NeverConn())

    def hook(slug, command):
        raise P.errors.ControlPlaneError(f"refused {slug}/{command}")
    reg.delivery_hook = hook
    await reg.send_command("n1", "ping", {})


async def _hijack(P):
    reg = P.reg.AgentRegistry()
    reg.register("n1", NeverConn(), principal="a")
    reg.register("n1", NeverConn(), principal="b")


ERROR_CASES = {"not_connected": _not_connected, "timeout": _timeout,
               "agent_error": _agent_error, "disconnect": _disconnect,
               "delivery_hook": _delivery_hook, "hijack_refused": _hijack}


async def _batch_align(P):
    reg = P.reg.AgentRegistry(shard_table=P.shards.ShardTable(4))
    for i in range(20):
        reg.register(f"a{i}", AckConn(reg))
    items = [(f"a{i}", "cmd.x", {"i": i}) for i in range(20)]
    items.append(("ghost", "cmd.x", None))
    res = await reg.send_batch(items, timeout=5)
    return res, reg.last_batch_stats, reg.shard_census()


async def _batch_coalesce(P):
    reg = P.reg.AgentRegistry(shard_table=P.shards.ShardTable(4))
    reg.epoch_source = lambda: 7
    conns = [AckConn(reg) for _ in range(30)]
    for i, c in enumerate(conns):
        reg.register(f"a{i}", c)
    items = [(f"a{i}", "deploy.execute" if i % 2 else "deploy.down", None)
             for i in range(30)]
    res = await reg.send_batch(items, timeout=5)
    envs = [[(m, {k: v for k, v in e.items() if k != "request_id"})
             for m, e in c.envelopes] for c in conns]
    return res, reg.last_batch_stats, envs


async def _batch_empty(P):
    reg = P.reg.AgentRegistry(shard_table=P.shards.ShardTable(4))
    return await reg.send_batch([]), reg.last_batch_stats


async def _batch_disconnect(P):
    reg = P.reg.AgentRegistry(shard_table=P.shards.ShardTable(4))
    victim = NeverConn()
    reg.register("victim", victim)
    for i in range(8):
        reg.register(f"ok{i}", AckConn(reg, delay=0.05))
    items = ([("victim", "deploy.execute", None)]
             + [(f"ok{i}", "deploy.execute", None) for i in range(8)]
             + [("victim", "deploy.down", None)])
    task = asyncio.ensure_future(reg.send_batch(items, timeout=30))
    await asyncio.sleep(0.02)
    reg.unregister("victim", victim)
    res = await task
    return res, reg.inflight(), reg.shard_census()


async def _rebalance(P):
    reg = P.reg.AgentRegistry(shard_table=P.shards.ShardTable(4))
    for i in range(100):
        reg.register(f"srv-{i:03d}", AckConn(reg))
    moved = reg.rebalance(8)
    reg.unregister("srv-007")
    return moved, reg.shard_census(), reg.list_connected()[:5]


BATCH_CASES = {"align": _batch_align, "coalesce": _batch_coalesce,
               "empty": _batch_empty, "disconnect_mid_batch":
               _batch_disconnect, "rebalance": _rebalance}


def _plain(x):
    """Results with exceptions as their branch fields."""
    if isinstance(x, BaseException):
        return _err(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


class TestRegistry:
    @pytest.mark.parametrize("case", sorted(ERROR_CASES))
    def test_structured_errors_equal(self, case):
        out = []
        for P in BOTH:
            with pytest.raises(P.errors.ControlPlaneError) as e:
                run(ERROR_CASES[case](P))
            out.append(_err(e.value))
        assert out[1] == out[0]
        name, reason, retryable, _ = out[1]
        if case == "agent_error":
            assert name == "AgentCommandFailed" and retryable is False
        elif case != "hijack_refused":
            assert name == "AgentUnreachable" and retryable is True
            assert reason == {"not_connected": "not-connected",
                              "timeout": "timeout",
                              "disconnect": "disconnected",
                              "delivery_hook": "delivery"}[case]

    @pytest.mark.parametrize("case", sorted(BATCH_CASES))
    def test_send_batch_equal(self, case):
        ref, port = (_plain(run(BATCH_CASES[case](P))) for P in BOTH)
        assert port == ref
        if case == "coalesce":
            stats = port[1]
            assert (stats["label_lookups"], stats["epoch_lookups"]) == (2, 1)
            assert all(e["epoch"] == 7 for env in port[2] for _, e in env)
        if case == "disconnect_mid_batch":
            assert port[0][0][1] == port[0][-1][1] == "disconnected"
            assert port[1] == 0

    def test_command_metrics_move_alike(self):
        moved = []
        for P in BOTH:
            reg_m = P.metrics.REGISTRY
            before = reg_m.counter_values()
            run(_batch_coalesce(P))
            try:
                run(_timeout(P))
            except P.errors.ControlPlaneError:
                pass
            moved.append({k: v - before.get(k, 0.0)
                          for k, v in reg_m.counter_values().items()
                          if k.startswith(("fleet_agent_command",
                                           "fleet_agent_registrations"))
                          and v != before.get(k, 0.0)})
        assert moved[1] == moved[0]


# --------------------------------------------------------------------------
# the wire protocol
# --------------------------------------------------------------------------

FRAMES = [{"type": "hello", "identity": "n1", "token": None,
           "channels": ["agent"]},
          {"type": "request", "id": 7, "channel": "agent",
           "method": "deploy.execute", "payload": {"x": [1, 2.5, "é"]}},
          {"type": "response", "id": 7, "payload": {}, "error": None},
          {"type": "event", "channel": "c", "method": "m", "payload": {}}]


class TestProtocol:
    @pytest.mark.parametrize("i", range(len(FRAMES)))
    def test_encode_frame_byte_equal(self, i):
        assert PORT.protocol.encode_frame(FRAMES[i]) == \
            REF.protocol.encode_frame(FRAMES[i])

    def test_frame_cap_equal(self):
        big = {"blob": "x" * (1 << 20)}
        for P in BOTH:
            assert P.protocol.MAX_FRAME == 1 << 20
            with pytest.raises(P.protocol.RpcError, match="too large"):
                P.protocol.encode_frame(big)

    @pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF),
                                               (PORT, PORT)],
                             ids=["ref-port", "port-ref", "port-port"])
    def test_loopback_round_trip(self, server, client):
        async def go():
            srv = server.protocol.ProtocolServer(
                name="cp", welcome_extra=lambda: {"epoch": 3})
            events = []
            done = asyncio.Event()

            async def echo(conn, method, payload):
                if method == "boom":
                    raise ValueError("no")
                return {"method": method, "echo": payload,
                        "from": conn.identity}

            async def on_event(conn, method, payload):
                events.append((conn.identity, method, payload))
                done.set()

            srv.register_channel("echo", echo, on_event)
            host, port = await srv.start()
            conn, task = await client.protocol.ProtocolClient.connect(
                host, port, identity="agent-1")
            out = [conn.welcome,
                   await conn.request("echo", "hi", {"n": 1}, timeout=5)]
            for method, channel in (("boom", "echo"), ("x", "nope")):
                with pytest.raises(client.protocol.RpcError) as e:
                    await conn.request(channel, method, {}, timeout=5)
                out.append(str(e.value))
            await conn.send_event("echo", "note", {"k": "v"})
            await asyncio.wait_for(done.wait(), 5)
            out.append(events)
            await conn.close()
            await srv.stop()
            task.cancel()
            return out

        out = run(go())
        assert out == [{"type": "welcome", "server": "cp", "epoch": 3},
                       {"method": "hi", "echo": {"n": 1},
                        "from": "agent-1"},
                       "ValueError: no", "unknown channel 'nope'",
                       [("agent-1", "note", {"k": "v"})]]


# --------------------------------------------------------------------------
# the reconverger (the reference's TestReconverger on both)
# --------------------------------------------------------------------------

class FakePlacement:
    def __init__(self, placement=None, moves=None, fail=None):
        self.placement = placement
        self.moves = moves or []
        self.fail = list(fail or [])
        self.committed = []
        self.calls = 0

    def retained(self, key):
        return (None, self.placement) if self.placement else None

    def node_events(self, events):
        self.calls += 1
        if self.fail:
            raise self.fail.pop(0)
        return list(self.moves)

    def commit_retained(self, key):
        self.committed.append(key)
        return True


def _state(P, store, placement):
    registry = P.reg.AgentRegistry()
    if P is REF:
        return AppState(store=store, auth=None, agent_registry=registry,
                        log_router=None, placement=placement)
    return SimpleNamespace(store=store, agent_registry=registry,
                           placement=placement)


def _heal_flow(P):
    m = P.model
    flow = m.Flow(name="healdemo")
    flow.services["web"] = m.Service(
        name="web", image="app", version="1",
        resources=m.ResourceSpec(cpu=0.5, memory=128.0))
    flow.stages["main"] = m.Stage(name="main", services=["web"],
                                  servers=["node-1", "node-2"])
    return flow


def _seed_template(P, db) -> None:
    db.create("deployments", P.models.Deployment(
        tenant="default", project="p", stage="s",
        status=P.models.DeploymentStatus.SUCCEEDED.value,
        request={"flow": P.serialize.flow_to_dict(_heal_flow(P)),
                 "stage_name": "main"}))


def _one_web(P, **kw):
    return P.base.Placement(assignment={"web": "node-1"}, levels=[["web"]],
                            feasible=True, **kw)


def _rc(P, state, clock, **cfg):
    conf = dict(backoff_base_s=1.0, backoff_max_s=8.0, max_attempts=3)
    conf.update(cfg)
    det = P.fd.FailureDetector(P.fd.LeaseConfig(), clock=clock.now)
    return P.rc.Reconverger(state, det, config=P.rc.ReconvergeConfig(**conf),
                            clock=clock.now, rng=random.Random(0))


def _parked(db) -> list:
    return sorted((r.stage_key, r.reason, r.parked, r.attempt, r.detail)
                  for r in db.list("parked_work"))


def _status(rc) -> dict:
    st = rc.status()
    st.pop("resident")      # the solver counters: each package's own
    return st


def _backoff(P):
    clock = FakeClock()
    db = P.store.Store()
    _seed_template(P, db)
    rc = _rc(P, _state(P, db, FakePlacement(_one_web(P))), clock)
    rc._enqueue("healdemo/main", "tr1")

    async def go():
        delays, summaries = [], []
        for _ in range(3):
            summaries.append(await rc.step())
            w = rc._work.get("healdemo/main")
            if w is None or w.parked:
                break
            delays.append(w.next_try_at - clock.t)
            clock.t = w.next_try_at + 0.001
        return delays, summaries

    delays, summaries = run(go())
    return (delays, summaries, rc.parked_stage_keys(), dict(rc.stats),
            _parked(db), _status(rc))


def _infeasible(P):
    clock = FakeClock()
    placement = FakePlacement(moves=[("healdemo/main", P.base.Placement(
        assignment={}, levels=[], feasible=False, violations=3))])
    db = P.store.Store()
    rc = _rc(P, _state(P, db, placement), clock)
    rc.detector.observe_heartbeat("node-1")
    clock.t = 1000.0

    async def go():
        first = await rc.step()
        clock.t += 1000.0
        return first, await rc.step()

    return run(go()), rc.parked_stage_keys(), dict(rc.stats), _parked(db)


def _redelivery(P):
    clock = FakeClock()
    db = P.store.Store()
    _seed_template(P, db)
    placement = FakePlacement(_one_web(P))
    state = _state(P, db, placement)
    rc = _rc(P, state, clock)
    seen = []

    class Conn:
        _closed = False
        identity = "node-1"

        async def send_event(self, channel, method, payload):
            seen.append((method, payload))
            state.agent_registry.resolve_result(
                payload["request_id"], {"result": {"deployed": ["web"]}})

    state.agent_registry.register("node-1", Conn())
    rc._enqueue("healdemo/main", "tr1")
    summary = run(rc.step())
    method, env = seen[0]
    payload = dict(env["payload"])
    key = payload.pop("idempotency_key")
    request = dict(payload.pop("request"))
    assert request.pop("trace_id") == "tr1"
    heal = [d for d in db.list("deployments") if d.log.startswith("self-heal")]
    records = [(d.tenant, d.status, d.services, d.placement, d.request,
                d.log) for d in heal]
    assert key.startswith("heal-healdemo/main-")
    return (summary, placement.committed, rc._work, method, payload,
            request, records, dict(rc.stats),
            [(s.name, s.status) for s in db.list("services")])


def _unpark(P):
    clock = FakeClock()
    db = P.store.Store()
    _seed_template(P, db)
    rc = _rc(P, _state(P, db, FakePlacement(_one_web(P))), clock)
    rc._park(P.rc._Work(stage_key="healdemo/main", idempotency_key="k",
                        trace_id="t"), "infeasible")
    rc.detector.observe_heartbeat("node-9")
    summaries = []
    for t, hb in ((1000.0, False), (2000.0, False), (2001.0, True)):
        clock.t = t
        if hb:
            rc.detector.observe_heartbeat("node-9")
        summaries.append(run(rc.step()))
    w = rc._work["healdemo/main"]
    assert w.idempotency_key.startswith("heal-healdemo/main-")
    assert w.idempotency_key != "k"
    return (summaries, rc.parked_stage_keys(), rc.pending_stage_keys(),
            (w.parked, w.attempt, w.reason, w.trace_id == "t"),
            dict(rc.stats), _parked(db))


def _requeued(P):
    clock = FakeClock()
    placement = FakePlacement(fail=[RuntimeError("solver down")])
    rc = _rc(P, _state(P, P.store.Store(), placement), clock)
    rc.detector.observe_heartbeat("node-1")
    summaries = []
    for t in (1000.0, 2000.0, 2000.0):
        clock.t = t
        summaries.append(run(rc.step()))
    return summaries, placement.calls, dict(rc.stats)


def _deploy_failed(P):
    """An agent that ran the redelivery and failed it: the stage parks
    (a fatal AgentCommandFailed is never retried verbatim)."""
    clock = FakeClock()
    db = P.store.Store()
    _seed_template(P, db)
    state = _state(P, db, FakePlacement(_one_web(P)))
    rc = _rc(P, state, clock)
    state.agent_registry.register("node-1",
                                  AckConn(state.agent_registry, error="no"))
    rc._enqueue("healdemo/main", "tr1")
    return run(rc.step()), rc.parked_stage_keys(), dict(rc.stats), _parked(db)


RC_CASES = {"backoff_grows_then_parks": _backoff,
            "infeasible_resolve_parks_immediately": _infeasible,
            "successful_redelivery_commits_and_records": _redelivery,
            "node_online_unparks": _unpark,
            "verdicts_requeued_when_resolve_crashes": _requeued,
            "deploy_failed_parks": _deploy_failed}


class TestReconverger:
    @pytest.mark.parametrize("case", sorted(RC_CASES))
    def test_same_outcome(self, case):
        ref, port = (RC_CASES[case](P) for P in BOTH)
        assert port == ref
        # the reference test's own expectations, on the port
        if case == "backoff_grows_then_parks":
            delays, _, parked, _, records, _ = port
            assert len(delays) == 2
            assert 0.75 <= delays[0] <= 1.25 and 1.5 <= delays[1] <= 2.5
            assert parked == ["healdemo/main"]
            assert records[0][:3] == ("healdemo/main", "retries-exhausted",
                                      True)
        if case == "infeasible_resolve_parks_immediately":
            assert port[0][1]["dead"] == ["node-1"]
            assert port[1] == ["healdemo/main"]
        if case == "successful_redelivery_commits_and_records":
            summary, committed, work, method, payload = port[:5]
            assert summary["redelivered"] == ["healdemo/main"]
            assert committed == ["healdemo/main"] and work == {}
            assert method == "deploy.execute"
            assert payload["assignment"] == {"web": "node-1"}
            assert len(port[6]) == 1 and port[6][0][3] == {"web": "node-1"}
        if case == "node_online_unparks":
            assert port[0][-1]["online"] == ["node-9"]
            assert port[1] == [] and "healdemo/main" in port[2]
        if case == "verdicts_requeued_when_resolve_crashes":
            assert port[1] == 2 and port[0][-1]["dead"] == ["node-1"]

    @pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                             ids=["ref-writes", "port-writes"])
    def test_parked_work_survives_restart_across_packages(self, writer,
                                                          reader, tmp_path):
        clock = FakeClock()
        path = str(tmp_path / "cp.json")
        db = writer.store.Store(path)
        rc = _rc(writer, _state(writer, db, FakePlacement()), clock)
        rc._park(writer.rc._Work(stage_key="p/s", idempotency_key="k",
                                 trace_id="t"), "infeasible", "no capacity")
        rc._enqueue("q/t", "tr")
        db.flush()
        db2 = reader.store.Store(path)
        rc2 = _rc(reader, _state(reader, db2, FakePlacement()), clock)
        assert rc2.resume() == 2
        assert rc2.parked_stage_keys() == ["p/s"]
        assert rc2.pending_stage_keys() == ["q/t"]
        assert rc2.stats["resumed"] == 2
        assert _parked(db2) == _parked(db)

    def test_keys_unique_across_restarts(self):
        clock = FakeClock()
        a = _rc(PORT, _state(PORT, PORT.store.Store(), FakePlacement()),
                clock)
        b = _rc(PORT, _state(PORT, PORT.store.Store(), FakePlacement()),
                clock)
        assert a._next_key("p/s") != b._next_key("p/s")
        assert a._next_key("p/s") != a._next_key("p/s")

    def test_rebuild_from_template_on_a_fresh_service(self):
        """Work whose stage this process never solved re-solves from the
        stored template (the failover path), then redelivers."""
        out = []
        for P in BOTH:
            clock = FakeClock()
            db = P.store.Store()
            _seed_template(P, db)

            class Rebuilding(FakePlacement):
                def solve_stage(self, flow, stage, tenant, reserve):
                    self.placement = _one_web(P)
                    self.solved = (flow.name, stage, tenant, reserve)

            placement = Rebuilding()
            state = _state(P, db, placement)
            state.agent_registry.register("node-1",
                                          AckConn(state.agent_registry))
            rc = _rc(P, state, clock)
            rc._enqueue("healdemo/main", "tr1")
            out.append((run(rc.step()), placement.solved, dict(rc.stats)))
        assert out[1] == out[0]
        assert out[1][2]["rebuilt_solves"] == 1


# --------------------------------------------------------------------------
# device faults end the loop; other errors are retried
# --------------------------------------------------------------------------

def _device_faults():
    from fleetflow_tpu_torch.core.errors import (DeviceUnavailable,
                                                 KernelError, SolverError)

    def wrapped():
        try:
            raise KernelError("k2 launch failed")
        except KernelError as e:
            try:
                raise SolverError("host placer failed") from e
            except SolverError as outer:
                return outer

    out = {"kernel-error": KernelError("cudaErrorLaunchFailure"),
           "device-unavailable": DeviceUnavailable("no CUDA"),
           "raised-from-kernel-error": wrapped()}
    if hasattr(torch, "OutOfMemoryError"):
        out["out-of-memory"] = torch.OutOfMemoryError("CUDA out of memory")
    return out


DEVICE_FAULTS = _device_faults()


def _dead_verdict_rc(placement, interval_s=0.0):
    clock = FakeClock()
    state = _state(PORT, PORT.store.Store(), placement)
    rc = _rc(PORT, state, clock, interval_s=interval_s)
    rc.detector.observe_heartbeat("node-1")
    clock.t = 1000.0
    run(rc.step())              # suspect
    clock.t = 2000.0            # the next sweep says dead
    return rc, clock


class TestDeviceFaults:
    @pytest.mark.parametrize("name", sorted(DEVICE_FAULTS))
    def test_step_requeues_and_raises(self, name):
        fault = DEVICE_FAULTS[name]
        placement = FakePlacement(fail=[fault])
        rc, _ = _dead_verdict_rc(placement)
        with pytest.raises(type(fault)):
            run(rc.step())
        assert placement.calls == 1
        # the verdict was requeued: the next step hands it out again
        summary = run(rc.step())
        assert summary["dead"] == ["node-1"] and placement.calls == 2

    @pytest.mark.parametrize("name", sorted(DEVICE_FAULTS))
    def test_run_loop_ends_with_the_fault(self, name):
        fault = DEVICE_FAULTS[name]
        placement = FakePlacement(fail=[fault])
        rc, _ = _dead_verdict_rc(placement)

        async def go():
            task = rc.spawn()
            with pytest.raises(type(fault)) as e:
                await asyncio.wait_for(task, 5)
            return e.value

        assert run(go()) is fault
        assert placement.calls == 1

    def test_run_loop_retries_other_errors(self, caplog):
        placement = FakePlacement(fail=[RuntimeError("solver down"),
                                        RuntimeError("again")])
        rc, _ = _dead_verdict_rc(placement)

        async def go():
            task = rc.spawn()
            for _ in range(200):
                await asyncio.sleep(0.005)
                if placement.calls >= 3:
                    break
            alive = not task.done()
            rc.stop()
            await asyncio.sleep(0)
            return alive

        with caplog.at_level("ERROR", logger="fleetflow.cp.reconverge"):
            assert run(go())
        assert placement.calls >= 3
        assert rc.stats["verdicts_dead"] >= 3
        assert "verdict handling failed" in caplog.text

    def test_the_reference_retries_what_the_port_ends_on(self):
        """The deliberate difference: the reference logs a KernelError
        like any failed step and goes on."""
        from fleetflow_tpu_torch.core.errors import KernelError
        clock = FakeClock()
        placement = FakePlacement(fail=[KernelError("x")])
        rc = _rc(REF, _state(REF, REF.store.Store(), placement), clock)
        rc.detector.observe_heartbeat("node-1")
        for t in (1000.0, 2000.0):
            clock.t = t
            run(rc.step())
        assert placement.calls == 1      # swallowed, verdict requeued

    @pytest.mark.parametrize("name", ["kernel-error",
                                      "raised-from-kernel-error"])
    def test_rebuild_solve_fault_is_not_retried(self, name):
        fault = DEVICE_FAULTS[name]
        clock = FakeClock()
        db = PORT.store.Store()
        _seed_template(PORT, db)

        class Broken(FakePlacement):
            def solve_stage(self, *a, **kw):
                raise fault

        state = _state(PORT, db, Broken())
        rc = _rc(PORT, state, clock)
        rc._enqueue("healdemo/main", "tr1")
        with pytest.raises(type(fault)):
            run(rc.step())
        assert rc.stats["redeliveries_retried"] == 0

    @pytest.mark.parametrize("error", ["kernel-error", "plain"])
    def test_rehydrate_fault_propagates_plain_error_is_logged(self, error):
        """resume() re-adopts committed placements; a device fault there
        propagates, any other failure is logged and skipped."""
        fault = (DEVICE_FAULTS["kernel-error"] if error == "kernel-error"
                 else RuntimeError("bad record"))
        db = PORT.store.Store()
        _seed_template(PORT, db)
        db.create("placements", PORT.models.PlacementRecord(
            stage_key="healdemo/main", assignment={"web": "node-1"}))

        class Rehydrating(FakePlacement):
            def rehydrate(self, key, flow, tenant):
                raise fault

        rc = _rc(PORT, _state(PORT, db, Rehydrating()), FakeClock())
        if error == "plain":
            assert rc.resume() == 0
            assert "rehydrated" not in rc.stats
        else:
            with pytest.raises(type(fault)):
                rc.resume()

    def test_plain_rebuild_error_is_retried(self):
        clock = FakeClock()
        db = PORT.store.Store()
        _seed_template(PORT, db)

        class Broken(FakePlacement):
            def solve_stage(self, *a, **kw):
                raise RuntimeError("store hiccup")

        rc = _rc(PORT, _state(PORT, db, Broken()), clock)
        rc._enqueue("healdemo/main", "tr1")
        summary = run(rc.step())
        assert summary["retried"] == ["healdemo/main"]


# --------------------------------------------------------------------------
# end to end at small size
# --------------------------------------------------------------------------

E2E_FLEET = dict(fleet="t0", n_services=60, seed=100, n_nodes_hint=12,
                 port_base=10000)
E2E_SECOND = dict(fleet="t1", n_services=20, seed=101, n_nodes_hint=12,
                  port_base=30000)
E2E_SERVERS = 12


def _fleet(P):
    parse = P.parser.parse_kdl_string
    flow = parse(P.fleetgen.generate_fleet_kdl(
        E2E_FLEET["fleet"], E2E_FLEET["n_services"], seed=E2E_FLEET["seed"],
        n_nodes_hint=E2E_FLEET["n_nodes_hint"],
        port_base=E2E_FLEET["port_base"]), cache=False)
    pool = parse(P.fleetgen.generate_servers_kdl(E2E_SERVERS, seed=7),
                 cache=False)
    return flow, pool


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    """chip_smoke's [heal] on the CPU: no sync to make, and the plain
    versions launch no kernel to count."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cp_expect_launches",
                        lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))


class TestEndToEnd:
    def test_card_scheduler_heals_on_cpu(self, cpu_rehearsal, tmp_path,
                                         monkeypatch, capsys):
        """chip_smoke's [heal] phase with the card scheduler's plain
        versions: one killed node, then three, healed with every check of
        the phase held; the heal's spans share one trace."""
        from fleetflow_tpu_torch import _ext, core
        from fleetflow_tpu_torch.cp import models, placement
        from fleetflow_tpu_torch.cp.store import Store
        from fleetflow_tpu_torch.lower import fleetgen
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
        from fleetflow_tpu_torch.solver.repair import verify
        trace_file = tmp_path / "flight.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(trace_file))
        flow, pool = _fleet(PORT)
        chip_smoke.run_heal_phase(
            torch, np, (_ext, models, Store, placement, REGISTRY, verify,
                        fleetgen, core), "cpu", flow, pool, "CARD",
            device="cpu", second=E2E_SECOND, burst2=3)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[heal] {\"burst\"")]
        assert len(lines) == 2
        events = PORT.trace.read_trace_file(str(trace_file))
        heals = [e for e in events if e["name"] == "reconverge"
                 and e["kind"] == "begin"]
        assert len(heals) == 2
        for begin in heals:
            trace = begin["trace"]
            named = {e["name"] for e in events if e["trace"] == trace}
            # detection, redelivery and every agent's deploy: one trace
            assert {"reconverge", "heal.redeliver",
                    "deploy.execute"} <= named, named
        # the re-solves ran on the executor thread, each under a trace
        solves = [e for e in events if e["name"] == "solve.trace"]
        assert len(solves) >= 6 and all(e["trace"] for e in solves)

    def test_host_paths_equal_step_by_step(self):
        """Both packages' host greedy paths (the reference's default, the
        port's use_gpu=False) through the same heal drive give equal
        summaries, assignments, Deployment records and backend states
        after the setup and after each burst."""
        traces = []
        for P in BOTH:
            kit = chip_smoke.heal_kit(P.name)
            flow, pool = _fleet(P)
            flow2 = P.parser.parse_kdl_string(P.fleetgen.generate_fleet_kdl(
                E2E_SECOND["fleet"], E2E_SECOND["n_services"],
                seed=E2E_SECOND["seed"],
                n_nodes_hint=E2E_SECOND["n_nodes_hint"],
                port_base=E2E_SECOND["port_base"]), cache=False)
            store = chip_smoke.cp_store(P.models, P.store.Store, pool)
            svc = (P.placement.PlacementService(store) if P is REF else
                   P.placement.PlacementService(store, use_gpu=False))
            keys = []
            for fl in (flow, flow2):
                _pl, rid = svc.solve_stage(fl, "prod")
                assert svc.commit(rid)
                keys.append(f"{fl.name}/prod")
            slugs = sorted(s.slug for s in store.list("servers"))
            world = chip_smoke.HealWorld(kit, store, svc, slugs)
            trace = []
            try:
                for fl in (flow, flow2):
                    world.deploy(fl, "prod")
                trace.append(("setup", _world_state(world, keys)))
                victim = chip_smoke.busiest_shared(svc, *keys)
                for victims, disconnect in (([victim], True),
                                            (None, False)):
                    if victims is None:
                        live = sorted(set(slugs) - world.silent)
                        victims = [str(x) for x in np.random.default_rng(
                            1).choice(live, 3, replace=False)]
                    world.kill(victims, disconnect=disconnect)
                    summary, ticks = world.until_verdict()
                    for key in keys:
                        assert not world.misplaced(key)
                    trace.append((summary, ticks, world.clock.now(),
                                  _world_state(world, keys)))
            finally:
                world.close()
            traces.append(trace)
        assert traces[1] == traces[0]
        assert traces[1][1][0]["redelivered"] == sorted(
            traces[1][1][0]["redelivered"]) and len(
            traces[1][1][0]["redelivered"]) >= 1


def _world_state(world, keys) -> dict:
    """What the drive left: assignments, Deployment records, the agents'
    containers and networks, the reconverger's stats."""
    deps = [(d.tenant, d.status, d.services, d.placement,
             {k: v for k, v in (d.request or {}).items() if k != "flow"},
             d.log) for d in world.store.list("deployments")]
    backends = {}
    for slug, agent in sorted(world.fleet.agents.items()):
        b = agent.backend
        backends[slug] = ({n: (i.image, i.state, i.health,
                               sorted(i.labels.items()), i.ports)
                           for n, i in sorted(b.containers.items())},
                          sorted(b.networks), sorted(b.images))
    return dict(assignments={k: world.svc.retained(k)[1].assignment
                             for k in keys},
                deployments=deps, backends=backends,
                stats=dict(world.rc.stats),
                parked=world.rc.parked_stage_keys())
