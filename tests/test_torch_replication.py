"""The port's control-plane replication (fleetflow_tpu_torch.cp.replication)
against the reference's (fleetflow_tpu.cp.replication), on the CPU.

- journal shipping across packages: a seeded workload on one package's
  primary Store (tables, the batched observed path, deletes) shipped to
  the other package's StandbyReplica, both ways, gives byte-identical
  tables, seq and epoch; a journaled primary compacting mid-stream ships
  on unaffected;
- the replication units of tests/test_replication.py on both packages:
  a sequence gap raises ReplicationGap and snapshot catch-up from the
  other package repairs it, entries already applied skip idempotently,
  a promoted standby fences the old primary's epoch (and counts it), a
  promoted primary's epoch entry reaches its own standbys;
- the Replicator's ring: a standby far behind is told to take a
  snapshot, installs it (into the other package's replica) and then
  streams; the status and lag after an ack equal the reference's;
- the election: the most caught-up standby wins, ties break on identity.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import random
import re
from types import SimpleNamespace

import pytest

_MODS = dict(repl="cp.replication", store="cp.store", models="cp.models",
             metrics="obs.metrics")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)
PAIRS = {"ref_to_port": (REF, PORT), "port_to_ref": (PORT, REF),
         "port_to_port": (PORT, PORT)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def _tables_doc(store) -> str:
    doc = store.snapshot_doc()
    doc.pop("_meta", None)
    return json.dumps(doc, sort_keys=True)


def _full_doc(store) -> str:
    return json.dumps(store.snapshot_doc(), sort_keys=True)


def _random_ops(pkg, store, rng: random.Random, n: int) -> None:
    m = pkg.models
    for i in range(n):
        op = rng.randrange(6)
        if op == 0:
            store.create("tenants", m.Tenant(name=f"t{rng.randrange(20)}-{i}"))
        elif op == 1:
            store.register_server(f"node-{rng.randrange(8)}",
                                  hostname=f"h{i}")
        elif op == 2:
            rows = store.list("servers")
            if rows:
                s = rng.choice(rows)
                store.update("servers", s.id,
                             status=rng.choice(("online", "offline")))
        elif op == 3:
            rows = store.list("tenants")
            if rows:
                store.delete("tenants", rng.choice(rows).id)
        elif op == 4:
            store.upsert_alert(f"node-{rng.randrange(8)}", "c", "unhealthy",
                               f"m{i}")
        else:
            store.replace_observed(f"node-{rng.randrange(4)}", [
                m.ObservedContainer(name=f"c{j}", image="img",
                                    state="running")
                for j in range(rng.randrange(3))])


def _clock():
    t = [1000.0]

    def now():
        t[0] += 0.5
        return t[0]
    return now


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_stream_across_packages_byte_identical(pair, seed):
    src, dst = PAIRS[pair]
    primary = src.store.Store(clock=_clock())
    standby = dst.store.Store()
    replica = dst.repl.StandbyReplica(standby)
    primary.replication_sink = replica.apply_lines
    _random_ops(src, primary, random.Random(100 + seed), 80)
    assert _full_doc(standby) == _full_doc(primary)
    assert (standby.seq, standby.epoch) == (primary.seq, primary.epoch)
    assert replica.applied == primary.seq


_RECORD_ID = re.compile(r"^[a-z_]+_[0-9a-f]{12}$")


def _masked(entries) -> list:
    """Shipped entries with each record id (random per store) replaced by
    its order of first appearance."""
    ids: dict = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, str) and _RECORD_ID.match(v):
            return ids.setdefault(v, f"id{len(ids)}")
        return v
    return [(seq, walk(json.loads(line))) for seq, line in entries]


def test_same_workload_same_journal_in_both():
    """One workload on each package's primary ships the same entries."""
    shipped = []
    for pkg in BOTH:
        primary = pkg.store.Store(clock=_clock())
        got = []
        primary.replication_sink = got.extend
        _random_ops(pkg, primary, random.Random(7), 60)
        shipped.append(_masked(got))
    assert len(shipped[1]) >= 60
    assert shipped[0] == shipped[1]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_compaction_mid_stream(pair, tmp_path):
    src, dst = PAIRS[pair]
    primary = src.store.Store(str(tmp_path / "cp.json"), clock=_clock())
    standby = dst.store.Store()
    replica = dst.repl.StandbyReplica(standby)
    replica.install(primary.snapshot_doc())
    primary.replication_sink = replica.apply_lines
    rng = random.Random(4)
    _random_ops(src, primary, rng, 30)
    primary.flush()                    # snapshot + journal truncate
    _random_ops(src, primary, rng, 30)
    assert _tables_doc(standby) == _tables_doc(primary)
    assert standby.seq == primary.seq


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_gap_forces_resync(pair):
    src, dst = PAIRS[pair]
    primary, standby = src.store.Store(), dst.store.Store()
    replica = dst.repl.StandbyReplica(standby)
    shipped = []
    primary.replication_sink = shipped.extend
    for i in range(6):
        primary.create("tenants", src.models.Tenant(name=f"t{i}"))
    replica.apply_lines(shipped[:2])
    with pytest.raises(dst.store.ReplicationGap):
        replica.apply_lines(shipped[4:])
    replica.install(primary.snapshot_doc())
    assert replica.last_seq == primary.seq
    assert replica.catchups == 1
    assert _tables_doc(standby) == _tables_doc(primary)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_already_applied_entries_skip(pair):
    src, dst = PAIRS[pair]
    primary, standby = src.store.Store(), dst.store.Store()
    replica = dst.repl.StandbyReplica(standby)
    shipped = []
    primary.replication_sink = shipped.extend
    for i in range(4):
        primary.create("tenants", src.models.Tenant(name=f"t{i}"))
    replica.install(primary.snapshot_doc())
    primary.create("tenants", src.models.Tenant(name="t4"))
    assert replica.apply_lines(shipped[2:4]) == 0
    assert replica.apply_lines(shipped[2:]) == 1
    assert _tables_doc(standby) == _tables_doc(primary)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_promote_fences_the_old_primary(pair):
    """Promotion bumps the standby's epoch; the dead primary's next write
    is refused at the standby's store and counted by its registry."""
    src, dst = PAIRS[pair]
    primary, standby = src.store.Store(), dst.store.Store()
    replica = dst.repl.StandbyReplica(standby)
    shipped = []
    primary.replication_sink = shipped.extend
    primary.create("tenants", src.models.Tenant(name="a"))
    replica.apply_lines(shipped)
    fenced = dst.metrics.REGISTRY.get(
        "fleet_replication_fencing_rejections_total")
    failovers = dst.metrics.REGISTRY.get("fleet_replication_failovers_total")
    before, f0 = fenced.value(side="store"), failovers.value()
    assert replica.promote() == 2
    assert standby.epoch == 2 and failovers.value() == f0 + 1
    primary.create("tenants", src.models.Tenant(name="zombie"))
    with pytest.raises(dst.store.ReplicationFenced):
        replica.apply_lines(shipped[1:])
    assert standby.tenant_by_name("zombie") is None
    assert fenced.value(side="store") == before + 1


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_epoch_bump_reaches_own_standbys(pair):
    src, dst = PAIRS[pair]
    primary = src.store.Store()
    gen2 = dst.store.Store()
    replica2 = dst.repl.StandbyReplica(gen2)
    replica2.install(primary.snapshot_doc())
    primary.replication_sink = replica2.apply_lines
    primary.bump_epoch()
    primary.create("tenants", src.models.Tenant(name="after"))
    assert gen2.epoch == 2
    assert gen2.tenant_by_name("after") is not None


class _Conn:
    identity = "sb"

    async def send_event(self, *a, **k):
        pass


def _ring_case(pkg, other):
    async def go():
        store = pkg.store.Store(clock=_clock())
        repl = pkg.repl.Replicator(store, config=pkg.repl.ReplicationConfig(
            ring_entries=8), loop=asyncio.get_running_loop())
        for i in range(30):
            store.create("tenants", pkg.models.Tenant(name=f"t{i}"))
        far = repl.attach(_Conn(), "sb", 0)
        meta, chunks = repl.snapshot_chunks()
        replica = other.repl.StandbyReplica(other.store.Store())
        replica.install(json.loads("".join(chunks)))
        near = repl.attach(_Conn(), "sb", replica.last_seq)
        return far, near, replica.last_seq == store.seq, sorted(meta)
    return run(go())


def _lag_case(pkg):
    async def go():
        store = pkg.store.Store(clock=_clock())
        repl = pkg.repl.Replicator(store, loop=asyncio.get_running_loop())
        conn = _Conn()
        repl.attach(conn, "sb", 0)
        for i in range(5):
            store.create("tenants", pkg.models.Tenant(name=f"t{i}"))
        await asyncio.sleep(0.05)
        sent = repl.status()["standbys"][0]["sent_seq"]
        repl.ack(conn, store.seq)
        st = repl.status()
        return (sent, store.seq, st["standbys"][0]["lag"], repl.max_lag())
    return run(go())


def test_replicator_ring_equal():
    ref = _ring_case(REF, PORT)
    port = _ring_case(PORT, REF)
    assert ref == port
    far, near, caught_up, _ = port
    assert far["snapshot_needed"] is True
    assert near.get("subscribed") is True and caught_up


def test_replicator_ack_lag_equal():
    assert _lag_case(REF) == _lag_case(PORT) == (5, 5, 0, 0)


ELECTION = [("sb-a", 10, {"sb-a": 10, "sb-b": 7}),
            ("sb-b", 7, {"sb-a": 10, "sb-b": 7}),
            ("sb-a", 9, {"sb-a": 9, "sb-b": 9}),
            ("sb-b", 9, {"sb-a": 9, "sb-b": 9}),
            ("sb-a", 3, {})]


def test_election_equal():
    out = []
    for pkg in BOTH:
        row = []
        for identity, seq, table in ELECTION:
            store = pkg.store.Store()
            store._seq = seq
            r = pkg.repl.StandbyRunner(pkg.repl.StandbyReplica(store),
                                       "127.0.0.1", 1, identity=identity)
            r._ack_table = dict(table)
            row.append(r._most_caught_up())
        out.append(row)
    assert out[0] == out[1] == [True, False, True, False, True]


def test_config_equal():
    for f in ("ring_entries", "ping_interval_s", "lease_s", "grace_s"):
        assert getattr(PORT.repl.ReplicationConfig(), f) == \
            getattr(REF.repl.ReplicationConfig(), f), f
