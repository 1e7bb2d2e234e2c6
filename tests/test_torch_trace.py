"""The port's traffic traces, plan simulation and agents' fan-out
scenario (fleetflow_tpu_torch.chaos.trace, .chaos.simulate,
.cp.bench_agents) against the reference's, on the CPU.

- tests/test_worldgen.py's TestTraceRoundTrip and TestPlanSimulate: a
  trace one package writes loads in the other to the same events, world,
  header and footer, and replays to the recording's event digest;
  ``simulate_flow`` on the port's host path (``use_gpu=False``) gives the
  reference's report, digest for digest, and on the card scheduler's
  plain versions (``device="cpu"``) a report that repeats;
- ``cp.bench_agents``' legs on both packages at a small size: every batch
  delivered, one metric lookup a batch, and the scan and heap sweeps
  handing out the same verdicts.
"""

from __future__ import annotations

import asyncio
import importlib
import json
from types import SimpleNamespace

import pytest

_MODS = dict(trace="chaos.trace", simulate="chaos.simulate",
             runner="chaos.runner", scenarios="chaos.scenarios",
             parser="core.parser", bench="cp.bench_agents")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
SIZE = dict(services=60, nodes=10, stages=2, pool_min=2)
SCENARIO = "diurnal-hotspot"


def _record(P, path, **kw):
    """Run the scenario on P's world and write its trace to `path`."""
    s = P.scenarios.build_schedule(SCENARIO, seed=7, services=60, nodes=10)
    rep = P.runner.run_schedule(s, **SIZE, **kw)
    P.trace.write_trace(path, s, rep, **SIZE)
    return s, rep


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The reference's recording and the port's host-path recording of
    one scenario (equal event digests: the host paths agree)."""
    d = tmp_path_factory.mktemp("traces")
    ref = _record(REF, d / "ref.jsonl")
    port = _record(PORT, d / "port.jsonl", use_gpu=False)
    return d, ref, port


class TestTraceRoundTrip:
    @pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                             ids=["ref-writes", "port-writes"])
    def test_trace_loads_across_packages(self, recorded, writer, reader):
        d, ref, port = recorded
        path = d / ("ref.jsonl" if writer is REF else "port.jsonl")
        s, rep = ref if writer is REF else port
        loaded, header, footer = reader.trace.load_trace(path)
        mine = writer.trace.load_trace(path)
        assert loaded.events() == s.events() == mine[0].events()
        assert loaded.world == s.world
        assert (header, footer) == (mine[1], mine[2])
        assert header["services"] == 60 and footer["digest"] == rep.digest()
        assert loaded.describe() == mine[0].describe()

    def test_same_trace_lines(self, recorded):
        """Line for line the same trace, but for the footer's wall-clock
        SLO baseline (host latencies, outside every digest)."""
        d, ref, port = recorded
        assert ref[1].digest() == port[1].digest()

        def lines(name):
            out = [json.loads(ln) for ln in
                   (d / name).read_text().splitlines()]
            out[-1]["baseline"].pop("wall", None)
            return out
        assert lines("port.jsonl") == lines("ref.jsonl")

    def test_port_replays_a_reference_trace(self, recorded):
        d, ref, _port = recorded
        loaded, _h, _f = PORT.trace.load_trace(d / "ref.jsonl")
        rep = PORT.runner.run_schedule(loaded, **SIZE, use_gpu=False)
        assert rep.digest() == ref[1].digest()

    def test_truncated_trace_fails_clearly(self, tmp_path):
        p = tmp_path / "bad.jsonl"
        p.write_text('{"kind": "event", "t": 1.0, "op": "tick", "p": {}}\n')
        for P in (REF, PORT):
            with pytest.raises(ValueError, match="no trace header"):
                P.trace.load_trace(p)


_PROPOSAL = '''
project "chaosfleet"
service "web" { resources { cpu 0.1; memory "64m" } }
service "db"  { resources { cpu 0.2; memory "128m" } }
stage "app0" { service "web" }
stage "app1" { service "db" }
'''


class TestPlanSimulate:
    def test_host_path_report_equals_the_reference(self, recorded):
        d, ref, _port = recorded
        path = d / "ref.jsonl"
        a = REF.simulate.simulate_flow(REF.parser.parse_kdl_string(_PROPOSAL),
                                       path)
        b = PORT.simulate.simulate_flow(
            PORT.parser.parse_kdl_string(_PROPOSAL), path, use_gpu=False)
        assert b["digest"] == a["digest"]
        assert b["events_digest"] == a["events_digest"]
        assert {k: v for k, v in b.items() if k != "wall_streams"} == \
            {k: v for k, v in a.items() if k != "wall_streams"}
        assert b["ok"] and b["trace"]["recorded_digest"] == ref[1].digest()

    def test_card_scheduler_report_repeats(self, recorded):
        d, _ref, _port = recorded
        path = d / "port.jsonl"
        flow = PORT.parser.parse_kdl_string(_PROPOSAL)
        a = PORT.simulate.simulate_flow(flow, path, device="cpu")
        b = PORT.simulate.simulate_flow(
            PORT.parser.parse_kdl_string(_PROPOSAL), path, device="cpu")
        assert a["digest"] == b["digest"]
        assert a["ok"], a["violations"]
        assert a["proposal"]["services"] == 2
        for stream in ("admission_wait_s", "heal_s"):
            assert stream in a["streams"]

    def test_wall_streams_stay_outside_the_digest(self):
        doc = {"kind": "plan-simulate-report", "streams": {},
               "wall_streams": {"proposed": {"placement_ms": {"p99": 1.0}}},
               "ok": True, "violations": []}
        d1 = PORT.simulate.report_digest(doc)
        assert d1 == REF.simulate.report_digest(json.loads(json.dumps(doc)))
        doc["wall_streams"]["proposed"]["placement_ms"]["p99"] = 999.0
        doc["ok"] = False
        doc["violations"] = ["[slo-met] wall miss"]
        assert PORT.simulate.report_digest(doc) == d1


class TestAgentsScenario:
    @pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
    def test_fanout_leg(self, P):
        out = asyncio.run(P.bench._fanout_leg(
            n_agents=64, shards=4, wire_s=0.0005, rounds=2,
            payload={"request": {"fleet": "x"}}, serial_sample=16))
        stats = out["last_batch_stats"]
        assert out["agents"] == 64 and out["batch_rounds"] == 2
        assert stats["items"] == 64
        assert 0 < stats["label_lookups"] < stats["items"]
        assert stats["epoch_lookups"] <= 1

    def test_sweep_leg_verdicts_equal(self):
        outs = [P.bench._sweep_leg(n=200, expired=10) for P in (REF, PORT)]
        for out in outs:
            assert out["verdict_parity"] is True
            assert out["engines"]["heap"]["expiry_verdicts"] == 10
            assert out["engines"]["scan"]["expiry_verdicts"] == 10
        assert [sorted(o["engines"]) for o in outs] == [["heap", "scan"]] * 2

    def test_agents_scenario_keys(self, monkeypatch):
        """The port's entry point returns the reference's report keys (the
        small scale with a short wire and one round)."""
        monkeypatch.setenv("BENCH_AGENTS_ROUNDS", "1")
        monkeypatch.setenv("BENCH_AGENTS_WIRE_MS", "0.05")
        monkeypatch.setenv("FLEET_CP_SHARDS", "4")
        out = PORT.bench.agents_scenario(small=True)
        assert sorted(out) == ["agents", "fanout", "redeliver", "shards",
                               "sweep", "wire_ms"]
        assert out["agents"] == 1000 and out["shards"] == 4
        assert out["sweep"]["verdict_parity"] is True
