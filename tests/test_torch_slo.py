"""The port's rolling SLO engine (fleetflow_tpu_torch/obs/slo.py) against the
reference's (fleetflow_tpu/obs/slo.py): the sketch, the windows, the
objective grammar and the engine, as the reference's tests hold them; the
same seeded sample stream gives the same quantiles in both packages,
exactly; the stream vocabulary and the sub-solve outcome vocabulary the
control plane reads are the reference's."""

from __future__ import annotations

import numpy as np
import pytest

from fleetflow_tpu.obs import slo as ref_slo
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.obs.slo import (KNOWN_STREAMS, QuantileSketch,
                                         RollingQuantile, SloEngine,
                                         get_engine, observe,
                                         parse_objective, parse_slo_props,
                                         set_engine)


@pytest.fixture(autouse=True)
def _no_global_engine():
    """Tests install their own engines; never leak one across tests."""
    prev = get_engine()
    set_engine(None)
    yield
    set_engine(prev)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------
# the sketch
# --------------------------------------------------------------------------

class TestQuantileSketch:
    def test_exact_below_capacity(self):
        sk = QuantileSketch(k=128)
        for v in [5.0, 1.0, 9.0, 3.0, 7.0]:
            sk.add(v)
        assert (sk.quantile(0.0), sk.quantile(0.5), sk.quantile(1.0)) == \
            (1.0, 5.0, 9.0)
        assert sk.n == 5

    def test_accuracy_at_scale(self):
        data = np.random.default_rng(7).exponential(scale=100.0, size=20_000)
        sk = QuantileSketch(k=128)
        for v in data:
            sk.add(float(v))
        for q in (0.5, 0.9, 0.99):
            exact = float(np.quantile(data, q))
            assert abs(sk.quantile(q) - exact) / exact < 0.25, q

    def test_deterministic(self):
        data = [float((i * 37) % 1000) for i in range(5000)]
        a, b = QuantileSketch(64), QuantileSketch(64)
        for v in data:
            a.add(v)
            b.add(v)
        assert a.levels == b.levels

    def test_merge_matches_union(self):
        rng = np.random.default_rng(3)
        xs, ys = rng.normal(50, 10, 4000), rng.normal(500, 50, 4000)
        a, b = QuantileSketch(128), QuantileSketch(128)
        for v in xs:
            a.add(float(v))
        for v in ys:
            b.add(float(v))
        m = a.merge(b)
        assert m.n == 8000
        rank = float((np.concatenate([xs, ys]) < m.quantile(0.5)).mean())
        assert abs(rank - 0.5) < 0.05
        assert a.n == 4000 and b.n == 4000

    @pytest.mark.parametrize("threshold,want", [(89.5, 0.10), (1e9, 0.0),
                                                (-1.0, 1.0)])
    def test_fraction_over(self, threshold, want):
        sk = QuantileSketch(k=128)
        for i in range(100):
            sk.add(float(i))
        assert sk.fraction_over(threshold) == pytest.approx(want)

    def test_bounded_memory(self):
        sk = QuantileSketch(k=64)
        for i in range(200_000):
            sk.add(float(i % 997))
        assert sum(len(lv) for lv in sk.levels) < 64 * (len(sk.levels) + 1)
        assert len(sk.levels) < 20


@pytest.mark.parametrize("k", [8, 64, 128])
def test_sketch_equals_the_reference_exactly(k):
    """The same numpy stream (seed 0) through both sketches: the same
    levels, quantiles, merges and fractions over, bit for bit."""
    rng = np.random.default_rng(0)
    xs = rng.lognormal(2.0, 1.0, 6000)
    ys = rng.exponential(30.0, 3000)
    port = (QuantileSketch(k), QuantileSketch(k))
    ref = (ref_slo.QuantileSketch(k), ref_slo.QuantileSketch(k))
    for data, p, r in ((xs, port[0], ref[0]), (ys, port[1], ref[1])):
        for v in data:
            p.add(float(v))
            r.add(float(v))
        assert p.levels == r.levels and p.n == r.n
    pm, rm = port[0].merge(port[1]), ref[0].merge(ref[1])
    assert pm.levels == rm.levels
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert port[0].quantile(q) == ref[0].quantile(q)
        assert pm.quantile(q) == rm.quantile(q)
    for t in (1.0, 10.0, 50.0, 500.0):
        assert pm.fraction_over(t) == rm.fraction_over(t)


class TestRollingQuantile:
    def test_window_expiry(self):
        rq = RollingQuantile(window_s=60.0, buckets=6)
        for t in range(10):
            rq.observe(1000.0, now=float(t))
        assert rq.sketch(now=10.0).quantile(0.5) == 1000.0
        assert rq.sketch(now=200.0) is None
        rq.observe(1.0, now=200.0)
        assert rq.sketch(now=200.0).quantile(0.99) == 1.0

    def test_bucket_recycling_drops_stale_epoch(self):
        rq = RollingQuantile(window_s=60.0, buckets=6)
        rq.observe(5.0, now=0.0)
        rq.observe(7.0, now=60.0 * 5)
        sk = rq.sketch(now=60.0 * 5)
        assert sk.quantile(0.0) == 7.0 and sk.n == 1


# --------------------------------------------------------------------------
# objective grammar
# --------------------------------------------------------------------------

class TestObjectiveGrammar:
    @pytest.mark.parametrize("name,threshold,want", [
        ("placement-p99-ms", 50, ("placement_ms", 0.99, 50.0, "ms")),
        ("admission-wait-p99-s", 60, ("admission_wait_s", 0.99, 60.0, "s")),
    ])
    def test_parse(self, name, threshold, want):
        o = parse_objective(name, threshold)
        assert (o.stream, o.quantile, o.threshold, o.unit) == want
        r = ref_slo.parse_objective(name, threshold)
        assert (o.name, o.stream, o.quantile, o.threshold, o.unit) == \
            (r.name, r.stream, r.quantile, r.threshold, r.unit)

    @pytest.mark.parametrize("bad,threshold", [
        ("placement-p99", 10),        # no unit
        ("placement-p42-ms", 10),     # unknown quantile
        ("placement-p99-days", 10),   # unknown unit
        ("nosuchstream-p99-ms", 10),  # unknown stream
        ("placement-p99-ms", 0),      # non-positive threshold
    ])
    def test_rejects_bad_grammar(self, bad, threshold):
        with pytest.raises(ValueError):
            parse_objective(bad, threshold)

    def test_parse_props_sorted_and_validated(self):
        objs = parse_slo_props({"placement-p99-ms": 50, "heal-p99-s": 30})
        assert [o.name for o in objs] == ["heal-p99-s", "placement-p99-ms"]
        with pytest.raises(ValueError):
            parse_slo_props({"heal-p99-s": 30, "typo-p99-ms": 1})

    def test_every_known_stream_reachable(self):
        for stream in KNOWN_STREAMS:
            base, unit = stream.rsplit("_", 1)
            name = f"{base.replace('_', '-')}-p99-{unit}"
            assert parse_objective(name, 1).stream == stream


def test_vocabularies_equal_the_reference():
    """The streams objectives may bind to, and the sub-solve outcome labels
    the control plane reads off fleet_solver_subsolve_total, are the
    reference's lists."""
    from fleetflow_tpu.solver.subsolve import SUB_OUTCOMES as ref_outcomes
    from fleetflow_tpu_torch.obs import slo as port_slo
    from fleetflow_tpu_torch.solver.subsolve import SUB_OUTCOMES
    assert KNOWN_STREAMS == ref_slo.KNOWN_STREAMS
    assert port_slo.EXPORTED_QUANTILES == ref_slo.EXPORTED_QUANTILES
    assert SUB_OUTCOMES == ref_outcomes


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class TestSloEngine:
    def test_status_objectives_vs_observed(self):
        clk = _Clock()
        eng = SloEngine(parse_slo_props({"placement-p99-ms": 50}), clock=clk)
        for _ in range(100):
            eng.observe("placement_ms", 10.0)
            clk.t += 1.0
        st = eng.status()
        (o,) = st["objectives"]
        assert o["met"] and o["samples"] == 100
        assert o["observed"] == pytest.approx(10.0)
        assert o["burn_fast"] == 0.0 and o["burn_slow"] == 0.0
        assert st["streams"]["placement_ms"]["p50"] == pytest.approx(10.0)

    def test_burn_rate_and_miss(self):
        clk = _Clock()
        eng = SloEngine(parse_slo_props({"placement-p99-ms": 50}), clock=clk)
        for i in range(100):
            eng.observe("placement_ms", 500.0 if i % 10 == 0 else 10.0)
            clk.t += 0.5
        (o,) = eng.status()["objectives"]
        assert not o["met"] and o["observed"] > 50
        assert o["burn_fast"] == pytest.approx(10.0, rel=0.2)
        # the gauges live on the port's registry
        assert REGISTRY.get("fleet_slo_objective_met").value(
            slo="placement-p99-ms") == 0.0
        assert REGISTRY.get("fleet_slo_burn_rate").value(
            slo="placement-p99-ms", window="fast") > 5.0

    def test_burn_recovers_in_fast_window(self):
        clk = _Clock()
        eng = SloEngine(parse_slo_props({"placement-p99-ms": 50}), clock=clk)
        for _ in range(50):
            eng.observe("placement_ms", 500.0)
            clk.t += 1.0
        clk.t += 400.0
        for _ in range(50):
            eng.observe("placement_ms", 5.0)
            clk.t += 1.0
        (o,) = eng.status()["objectives"]
        assert o["burn_fast"] == 0.0 and o["burn_slow"] > 0.0

    def test_streams_without_objectives_still_census(self):
        eng = SloEngine(clock=_Clock())
        eng.observe("heal_s", 2.0)
        st = eng.status()
        assert st["objectives"] == []
        assert st["streams"]["heal_s"]["samples"] == 1

    def test_module_observe_routes_to_installed_engine(self):
        eng = set_engine(SloEngine(clock=_Clock()))
        observe("heal_s", 3.0)
        assert eng.samples("heal_s") == 1
        set_engine(None)
        observe("heal_s", 3.0)
        assert eng.samples("heal_s") == 1

    def test_observed_quantile_none_before_samples(self):
        assert SloEngine(clock=_Clock()).observed_quantile("heal_s",
                                                           0.99) is None


def test_engine_status_equals_the_reference():
    """The same objectives, clock and seeded samples through both engines
    give the same status payload."""
    rng = np.random.default_rng(0)
    samples = [(float(rng.exponential(20.0)), float(rng.random() * 3))
               for _ in range(2000)]
    props = {"placement-p99-ms": 50, "admission-solve-p99-ms": 250}
    clk_p, clk_r = _Clock(), _Clock()
    port = SloEngine(parse_slo_props(props), clock=clk_p)
    ref = ref_slo.SloEngine(ref_slo.parse_slo_props(props), clock=clk_r)
    for i, (v, dt) in enumerate(samples):
        stream = ("placement_ms", "admission_solve_ms", "heal_s")[i % 3]
        port.observe(stream, v)
        ref.observe(stream, v)
        clk_p.t += dt
        clk_r.t += dt
    assert port.status() == ref.status()
