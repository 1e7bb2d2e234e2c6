"""Rolling SLO engine: streaming quantile sketches + burn-rate gauges
(copy of ``fleetflow_tpu/obs/slo.py``; the control plane's observation
points call it).

ROADMAP item 4 asks for *SLO invariants instead of only safety
invariants* — "the fleet converged" is necessary but not sufficient; the
operator's question is "did it converge FAST ENOUGH, consistently?".
This module is where that question gets a checked answer:

  QuantileSketch    deterministic KLL-style streaming quantile sketch:
                    bounded memory (~k floats per compaction level),
                    mergeable (the property windowed aggregation needs),
                    and derandomized (alternating compaction offsets) so
                    chaos replays and tests are exactly reproducible
  RollingQuantile   a ring of per-time-bucket sketches; querying merges
                    the live buckets, so "p99 over the last 5 minutes"
                    is one small merge, not a re-scan
  SloObjective      one declarative objective (`placement-p99-ms=50`):
                    stream, quantile, threshold, unit
  SloEngine         named observation streams (warm-reschedule latency,
                    admission wait + solve tail, verdict→converged
                    time-to-heal), lifetime + fast/slow windowed
                    sketches per stream, fast/slow burn-rate gauges on
                    /metrics, and the status payload `fleet slo status`
                    renders

Objective grammar (fleetflowd.kdl `slo` node, docs/guide/10):

    slo placement-p99-ms=50 heal-p99-s=30 admission-wait-p99-s=60 \
        admission-solve-p99-ms=250

Each property is `<stream>-p<NN>-<unit>=<threshold>`: the stream tokens
name an observation stream (`<stream>_<unit>` with dashes folded to
underscores — `admission-wait-p99-s` reads stream `admission_wait_s`),
`p<NN>` the quantile (p50/p90/p95/p99/p999), `<unit>` the value unit
(`ms` or `s`), and the value the threshold in that unit.

Burn rate follows the multiwindow SRE convention: for a p<q> objective
the error budget is the `1-q` fraction of requests allowed over the
threshold; `burn = (fraction over threshold in window) / budget`. Burn
1.0 means spending budget exactly as fast as allowed; the fast window
(default 5 min) catches a cliff, the slow window (default 1 h) catches a
smolder. Both ride `/metrics` as `fleet_slo_burn_rate{slo,window}`.

Observation points live where the latencies are born: the placement
service's churn re-solves (cp/placement.py), the admission controller's
wait/solve recording (cp/admission.py), and the reconverger's
verdict→converged bookkeeping (cp/reconverge.py) — each calls the
module-level :func:`observe`, which routes to the installed engine (a
per-process default; the chaos runner installs a virtual-clock engine
per world so the `slo-met` invariant judges virtual time).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from .metrics import REGISTRY

__all__ = ["QuantileSketch", "RollingQuantile", "SloObjective",
           "parse_objective", "parse_slo_props", "SloEngine",
           "set_engine", "get_engine", "observe",
           "KNOWN_STREAMS"]

# metric catalog: docs/guide/10-observability.md
_M_BURN = REGISTRY.gauge(
    "fleet_slo_burn_rate",
    "Error-budget burn rate per objective and window (fast = minutes, "
    "slow = the hour): fraction of windowed samples over the threshold "
    "divided by the objective's 1-q budget — sustained > 1 means the "
    "objective will be missed",
    labels=("slo", "window"))
_M_OBSERVED = REGISTRY.gauge(
    "fleet_slo_observed_quantile",
    "Observed lifetime quantile per objective, in the objective's unit "
    "(compare against the declared threshold)",
    labels=("slo",))
_M_MET = REGISTRY.gauge(
    "fleet_slo_objective_met",
    "1 when the observed lifetime quantile is within the objective's "
    "threshold (or no samples yet), else 0",
    labels=("slo",))
_M_SAMPLES = REGISTRY.counter(
    "fleet_slo_samples_total",
    "Latency samples folded into the SLO engine, per stream",
    labels=("stream",))
_M_STREAM_Q = REGISTRY.gauge(
    "fleet_slo_stream_quantile",
    "Observed lifetime quantile per observation stream, in the stream's "
    "unit — the same deterministic-sketch tails the slo-met chaos "
    "invariant judges, exported so external scrapers see them",
    labels=("stream", "quantile"))

# the percentiles every stream exports: matches
# the _QUANTILES grammar minus p999 (too noisy below ~10k samples)
EXPORTED_QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95),
                      ("p99", 0.99))

# the observation streams the control plane feeds today; objectives may
# only bind to these (a typo'd stream would otherwise be a silently
# never-sampled, vacuously-met objective — the chaos canary trap)
KNOWN_STREAMS = (
    "placement_ms",        # warm churn re-solve wall ms, per stage
    "admission_wait_s",    # admission submit → committed placement
    "admission_solve_ms",  # admission micro-solve wall ms
    "heal_s",              # dead verdict → stage reconverged
)


class QuantileSketch:
    """Deterministic KLL-style streaming quantile sketch.

    Level i holds items of weight 2**i; a full level sorts itself and
    promotes every other item (offset alternating per compaction — the
    standard derandomization, so two runs over one stream agree exactly)
    to level i+1. Memory is bounded by k floats per level and levels
    grow as log2(n/k) — a million samples at k=128 is ~10 levels of
    shared small lists. `merge` concatenates level-wise then re-compacts:
    the mergeability windowed aggregation is built on."""

    __slots__ = ("k", "levels", "n", "_coin")

    def __init__(self, k: int = 128):
        self.k = max(int(k), 8)
        self.levels: list[list[float]] = [[]]
        self.n = 0
        self._coin = 0

    def add(self, value: float) -> None:
        self.levels[0].append(float(value))
        self.n += 1
        if len(self.levels[0]) >= self.k:
            self._compact(0)

    def _compact(self, lvl: int) -> None:
        buf = sorted(self.levels[lvl])
        off = self._coin & 1
        self._coin += 1
        self.levels[lvl] = []
        if lvl + 1 == len(self.levels):
            self.levels.append([])
        self.levels[lvl + 1].extend(buf[off::2])
        if len(self.levels[lvl + 1]) >= self.k:
            self._compact(lvl + 1)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """New sketch holding both streams (inputs untouched)."""
        out = QuantileSketch(min(self.k, other.k))
        out.n = self.n + other.n
        out._coin = self._coin + other._coin
        for lvl in range(max(len(self.levels), len(other.levels))):
            if lvl == len(out.levels):
                out.levels.append([])
            for src in (self, other):
                if lvl < len(src.levels):
                    out.levels[lvl].extend(src.levels[lvl])
            if len(out.levels[lvl]) >= out.k:
                out._compact(lvl)
        return out

    def _weighted(self) -> list[tuple[float, int]]:
        pairs = [(v, 1 << lvl)
                 for lvl, buf in enumerate(self.levels) for v in buf]
        pairs.sort()
        return pairs

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile, or None when empty."""
        pairs = self._weighted()
        if not pairs:
            return None
        total = sum(w for _v, w in pairs)
        target = min(max(float(q), 0.0), 1.0) * total
        cum = 0
        for v, w in pairs:
            cum += w
            if cum >= target:
                return v
        return pairs[-1][0]

    def fraction_over(self, threshold: float) -> float:
        """Estimated fraction of the stream strictly over `threshold` —
        the burn-rate numerator. 0.0 when empty."""
        pairs = self._weighted()
        if not pairs:
            return 0.0
        total = sum(w for _v, w in pairs)
        over = sum(w for v, w in pairs if v > threshold)
        return over / total


class RollingQuantile:
    """Windowed quantiles: a ring of per-time-bucket sketches. Observing
    stamps the sample into the current bucket (lazily recycling a slot
    whose epoch has rotated out); querying merges the buckets still
    inside the window. Clock injectable — virtual in chaos."""

    def __init__(self, window_s: float, buckets: int = 6, k: int = 64):
        self.window_s = float(window_s)
        self.nb = max(int(buckets), 1)
        self.k = max(int(k), 8)
        self.bucket_s = self.window_s / self.nb
        # slot -> [epoch, sketch]
        self._ring: list[Optional[list]] = [None] * self.nb

    def observe(self, value: float, now: float) -> None:
        epoch = int(now / self.bucket_s)
        slot = epoch % self.nb
        cell = self._ring[slot]
        if cell is None or cell[0] != epoch:
            cell = [epoch, QuantileSketch(self.k)]
            self._ring[slot] = cell
        cell[1].add(value)

    def sketch(self, now: float) -> Optional[QuantileSketch]:
        """Merged sketch over the live window, or None when empty."""
        epoch = int(now / self.bucket_s)
        out: Optional[QuantileSketch] = None
        for cell in self._ring:
            if cell is None or cell[0] <= epoch - self.nb:
                continue
            out = cell[1] if out is None else out.merge(cell[1])
        return out


@dataclass(frozen=True)
class SloObjective:
    """One declared objective: `placement-p99-ms=50` parses to
    (name="placement-p99-ms", stream="placement_ms", quantile=0.99,
    threshold=50.0, unit="ms")."""
    name: str
    stream: str
    quantile: float
    threshold: float
    unit: str


_QUANTILES = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99,
              "p999": 0.999}


def parse_objective(name: str, threshold: float) -> SloObjective:
    """Parse one `<stream>-p<NN>-<unit>=<threshold>` objective."""
    parts = name.strip().lower().split("-")
    if len(parts) < 3:
        raise ValueError(
            f"SLO objective {name!r}: expected <stream>-p<NN>-<unit>")
    unit = parts[-1]
    if unit not in ("ms", "s"):
        raise ValueError(f"SLO objective {name!r}: unit must be ms or s, "
                         f"got {unit!r}")
    q = _QUANTILES.get(parts[-2])
    if q is None:
        raise ValueError(
            f"SLO objective {name!r}: quantile must be one of "
            f"{sorted(_QUANTILES)}, got {parts[-2]!r}")
    stream = "_".join(parts[:-2]) + "_" + unit
    if stream not in KNOWN_STREAMS:
        raise ValueError(
            f"SLO objective {name!r}: unknown stream {stream!r} "
            f"(known: {', '.join(KNOWN_STREAMS)})")
    t = float(threshold)
    if t <= 0:
        raise ValueError(f"SLO objective {name!r}: threshold must be > 0")
    return SloObjective(name=name.strip().lower(), stream=stream,
                        quantile=q, threshold=t, unit=unit)


def parse_slo_props(props: dict) -> list[SloObjective]:
    """Parse a fleetflowd.kdl `slo` node's properties; deterministic
    order (sorted by objective name)."""
    return [parse_objective(k, float(v))
            for k, v in sorted(props.items())]


class _Stream:
    __slots__ = ("life", "fast", "slow", "count", "last_refresh")

    def __init__(self, fast_s: float, slow_s: float, k: int):
        self.life = QuantileSketch(k)
        # windows hold bounded recent data: half the lifetime k keeps
        # the per-refresh merge cheap at equivalent rank accuracy
        self.fast = RollingQuantile(fast_s, buckets=6, k=max(k // 2, 32))
        self.slow = RollingQuantile(slow_s, buckets=12, k=max(k // 2, 32))
        self.count = 0
        self.last_refresh: Optional[float] = None


# minimum engine-clock seconds between gauge refreshes per stream: the
# sample fold itself is O(1) amortized, but a gauge refresh sorts the
# lifetime sketch and merges the window rings — doing that per sample
# on a 300-solves/s admission path would tax exactly the latencies the
# SLOs measure. Gauges tolerate a second of staleness; status() always
# computes fresh.
GAUGE_REFRESH_S = 1.0


class SloEngine:
    """The per-process SLO aggregator: observation streams in, burn-rate
    gauges and a status payload out. Thread-safe; the clock is
    injectable (time.monotonic in production, the chaos VirtualClock in
    `fleet chaos run`) so windows and burn rates are exact arithmetic on
    whichever clock drives the world."""

    def __init__(self, objectives: Iterable[SloObjective] = (), *,
                 clock: Callable[[], float] = time.monotonic,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0, k: int = 128):
        self.objectives = list(objectives)
        self.clock = clock
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._k = int(k)
        self._streams: dict[str, _Stream] = {}
        self._by_stream: dict[str, list[SloObjective]] = {}
        self._lock = threading.Lock()
        for o in self.objectives:
            self._by_stream.setdefault(o.stream, []).append(o)
            # the exposition surface is stable from engine construction:
            # a declared objective shows 'met' (vacuously) before its
            # first sample, not nothing
            _M_OBSERVED.set(0.0, slo=o.name)
            _M_MET.set(1.0, slo=o.name)
            _M_BURN.set(0.0, slo=o.name, window="fast")
            _M_BURN.set(0.0, slo=o.name, window="slow")

    # -- ingestion -----------------------------------------------------

    def observe(self, stream: str, value: float) -> None:
        """Fold one latency sample (in the stream's unit) into the
        lifetime + windowed sketches; refresh the stream's gauges at
        most once per GAUGE_REFRESH_S of engine clock."""
        now = self.clock()
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                st = self._streams[stream] = _Stream(
                    self.fast_window_s, self.slow_window_s, self._k)
            st.life.add(value)
            st.fast.observe(value, now)
            st.slow.observe(value, now)
            st.count += 1
            _M_SAMPLES.inc(stream=stream)
            # every stream refreshes at cadence now (not only objective-
            # bound ones): the quantile exposition gauges must track
            # streams nobody declared an objective for yet
            if (st.last_refresh is None
                    or now - st.last_refresh >= GAUGE_REFRESH_S):
                st.last_refresh = now
                self._refresh_locked(stream, st, now)

    def _refresh_locked(self, stream: str, st: _Stream,
                        now: float) -> None:
        # ONE window merge per ring, shared by every objective bound to
        # the stream (they differ only in quantile/threshold)
        for label, q in EXPORTED_QUANTILES:
            v = st.life.quantile(q)
            if v is not None:
                _M_STREAM_Q.set(v, stream=stream, quantile=label)
        if not self._by_stream.get(stream):
            return
        fast = st.fast.sketch(now)
        slow = st.slow.sketch(now)
        for o in self._by_stream.get(stream, ()):
            observed = st.life.quantile(o.quantile)
            if observed is not None:
                _M_OBSERVED.set(observed, slo=o.name)
                _M_MET.set(1.0 if observed <= o.threshold else 0.0,
                           slo=o.name)
            budget = max(1.0 - o.quantile, 1e-9)
            for window, sk in (("fast", fast), ("slow", slow)):
                burn = (sk.fraction_over(o.threshold) / budget
                        if sk is not None else 0.0)
                _M_BURN.set(burn, slo=o.name, window=window)

    def refresh(self) -> None:
        """Recompute every stream's gauges against the clock's NOW. The
        metrics surfaces call this before rendering (`/metrics`, the
        health.metrics channel): without it a stream that goes quiet
        would freeze its burn gauges at their last observed value — an
        empty rolled-past window must read burn 0, not the storm's
        peak."""
        now = self.clock()
        with self._lock:
            for stream, st in self._streams.items():
                st.last_refresh = now
                self._refresh_locked(stream, st, now)

    # -- introspection -------------------------------------------------

    def samples(self, stream: str) -> int:
        with self._lock:
            st = self._streams.get(stream)
            return st.count if st is not None else 0

    def observed_quantile(self, stream: str, q: float) -> Optional[float]:
        """Lifetime quantile of a stream (None before the first
        sample) — what the chaos `slo-met` invariant judges."""
        with self._lock:
            st = self._streams.get(stream)
            return st.life.quantile(q) if st is not None else None

    def status(self) -> dict:
        """`fleet slo status` payload: objectives vs observed quantiles
        + burn rates, plus the raw stream census."""
        now = self.clock()
        out: dict = {"enabled": True, "objectives": [], "streams": {}}
        with self._lock:
            for o in self.objectives:
                st = self._streams.get(o.stream)
                observed = st.life.quantile(o.quantile) if st else None
                fast = st.fast.sketch(now) if st else None
                slow = st.slow.sketch(now) if st else None
                budget = max(1.0 - o.quantile, 1e-9)
                out["objectives"].append({
                    "name": o.name, "stream": o.stream,
                    "quantile": o.quantile, "threshold": o.threshold,
                    "unit": o.unit,
                    "samples": st.count if st else 0,
                    "observed": (round(observed, 4)
                                 if observed is not None else None),
                    "observed_fast": (round(fast.quantile(o.quantile), 4)
                                      if fast is not None else None),
                    "burn_fast": (round(
                        fast.fraction_over(o.threshold) / budget, 3)
                        if fast is not None else 0.0),
                    "burn_slow": (round(
                        slow.fraction_over(o.threshold) / budget, 3)
                        if slow is not None else 0.0),
                    "met": observed is None or observed <= o.threshold,
                })
            for name in sorted(self._streams):
                st = self._streams[name]
                p50 = st.life.quantile(0.5)
                p99 = st.life.quantile(0.99)
                out["streams"][name] = {
                    "samples": st.count,
                    "p50": round(p50, 4) if p50 is not None else None,
                    "p99": round(p99, 4) if p99 is not None else None,
                }
        return out


# -- the per-process default engine ----------------------------------------

_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def set_engine(engine: Optional[SloEngine]) -> Optional[SloEngine]:
    """Install the process-wide engine the observation points route to
    (the CP server at start; the chaos runner per world, on the virtual
    clock). Returns the engine for chaining."""
    global _engine
    with _engine_lock:
        _engine = engine
    return engine


def get_engine() -> Optional[SloEngine]:
    return _engine


def observe(stream: str, value: float) -> None:
    """Route one sample to the installed engine; no-op (one attribute
    read) when none is installed — library embedders that never start a
    CP pay nothing."""
    e = _engine
    if e is not None:
        e.observe(stream, value)
