"""Fixed-memory ring-buffer time-series store (the fleet horizon; the
port's copy of ``fleetflow_tpu/obs/tsdb.py``).

Every observability surface before this one was point-in-time and
single-process: `/metrics` is a snapshot, the flight recorder is a
per-process JSONL of spans, and the SLO engine keeps sketches, not
samples. Tuning and capacity work both need *history* — you cannot re-tune
warm constants from telemetry you didn't retain, and you cannot find the
fan-out bottleneck without per-agent series. This module is the
retention layer:

  Series         one named, labeled series: a deque ring of (t, value)
                 samples — fixed memory per series, oldest falls off
  TimeSeriesDB   the per-process store: get-or-create series keyed by
                 (name, sorted label items), thread-safe record/query,
                 windowed aggregates (count/min/max/mean/last, counter
                 rate, p50/p90/p99 via `obs.slo.QuantileSketch`), a
                 deterministic `snapshot()` with a content digest (the
                 chaos capture artifact), and OpenMetrics / JSONL export

Zero dependencies beyond the stdlib and `obs.slo`'s sketch — the store
must be importable from host-only control planes (no torch) and from the
chaos world (no asyncio). The clock is injectable: `time.monotonic` in
production, the chaos `VirtualClock` under `fleet chaos run`, so a
captured scenario's timestamps are exact virtual seconds and replay
byte-identically (tests/test_torch_tsdb.py pins this).

Memory math (docs/guide/10-observability.md): a sample is one (float,
float) tuple ~56 B plus deque slot; at the defaults (512 samples x 4096
series cap) the worst case is ~120 MiB but a real CP tracks a few
hundred series — ~15 MiB, fixed, with no allocation on the steady path.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from .slo import QuantileSketch

__all__ = ["Series", "TimeSeriesDB", "SCHEMA_VERSION", "AGGREGATES",
           "snapshot_digest"]

# the capture artifact schema (chaos/runner.py writes it next to the
# event-log digest); bump on any shape change — consumers key on it
SCHEMA_VERSION = 1

AGGREGATES = ("count", "min", "max", "mean", "last", "rate",
              "p50", "p90", "p99")


def _label_key(labels: Optional[dict]) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Series:
    """One named+labeled series: a fixed-capacity ring of (t, value)."""

    __slots__ = ("name", "labels", "kind", "ring", "total")

    def __init__(self, name: str, labels: tuple, capacity: int,
                 kind: str = "gauge"):
        self.name = name
        self.labels = labels          # sorted ((k, v), ...) tuple
        self.kind = kind              # "gauge" | "counter"
        self.ring: deque = deque(maxlen=max(int(capacity), 2))
        self.total = 0                # lifetime samples (ring evicts)

    def append(self, t: float, value: float) -> None:
        self.ring.append((float(t), float(value)))
        self.total += 1

    def labels_dict(self) -> dict:
        return dict(self.labels)

    def samples(self, since: Optional[float] = None,
                until: Optional[float] = None) -> list:
        out = list(self.ring)
        if since is not None:
            out = [s for s in out if s[0] >= since]
        if until is not None:
            out = [s for s in out if s[0] <= until]
        return out

    def last(self) -> Optional[tuple]:
        return self.ring[-1] if self.ring else None


def _aggregate(samples: list, kind: str) -> dict:
    """The windowed aggregate block for one series. `rate` is the
    counter convention (last-first)/(t_last-t_first) and None for
    gauges or windows with fewer than two samples; quantiles ride the
    deterministic slo sketch so chaos replays agree exactly."""
    if not samples:
        return {"count": 0}
    values = [v for _t, v in samples]
    out = {"count": len(values),
           "min": min(values), "max": max(values),
           "mean": sum(values) / len(values),
           "last": values[-1]}
    rate = None
    if kind == "counter" and len(samples) >= 2:
        dt = samples[-1][0] - samples[0][0]
        dv = samples[-1][1] - samples[0][1]
        if dt > 0:
            rate = dv / dt
    out["rate"] = rate
    sk = QuantileSketch(64)
    for v in values:
        sk.add(v)
    for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        out[key] = sk.quantile(q)
    return out


class TimeSeriesDB:
    """The per-process store. One lock; every public method is safe to
    call from the sampler thread, asyncio handlers and chaos's single
    thread alike. Series creation beyond `max_series` is DROPPED (and
    counted) rather than evicting live history — under a label-cardinality
    explosion the store degrades to "new series lost", never to
    unbounded memory."""

    def __init__(self, *, capacity_per_series: int = 512,
                 max_series: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = int(capacity_per_series)
        self.max_series = int(max_series)
        self.clock = clock
        self._series: dict[tuple, Series] = {}
        self._lock = threading.Lock()
        self.samples_total = 0
        self.dropped_series = 0

    # -- ingestion -----------------------------------------------------

    def record(self, name: str, value: float,
               labels: Optional[dict] = None,
               t: Optional[float] = None, kind: str = "gauge") -> bool:
        """Append one sample; returns False when the series cap refused
        a NEW series (existing series always accept)."""
        key = (name, _label_key(labels))
        ts = self.clock() if t is None else float(t)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return False
                s = self._series[key] = Series(
                    name, key[1], self.capacity, kind)
            s.append(ts, value)
            self.samples_total += 1
        return True

    # -- introspection -------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def names(self) -> list[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def match(self, name: Optional[str] = None,
              labels: Optional[dict] = None) -> list[Series]:
        """Series selector: exact name (None = all), labels as a SUBSET
        match ({"agent": "node-1"} matches any series carrying it)."""
        want = _label_key(labels) if labels else ()
        with self._lock:
            out = []
            for s in self._series.values():
                if name is not None and s.name != name:
                    continue
                if want and not set(want) <= set(s.labels):
                    continue
                out.append(s)
        return sorted(out, key=lambda s: (s.name, s.labels))

    def query(self, name: Optional[str] = None,
              labels: Optional[dict] = None,
              window_s: Optional[float] = None,
              limit: Optional[int] = None) -> list[dict]:
        """Raw samples per matching series, newest window first by
        (name, labels) order; `limit` caps samples PER SERIES."""
        since = self.clock() - window_s if window_s else None
        out = []
        for s in self.match(name, labels):
            samples = s.samples(since=since)
            if limit:
                samples = samples[-int(limit):]
            out.append({"name": s.name, "labels": s.labels_dict(),
                        "kind": s.kind,
                        "samples": [[t, v] for t, v in samples]})
        return out

    def aggregate(self, name: Optional[str] = None,
                  labels: Optional[dict] = None,
                  window_s: Optional[float] = None) -> list[dict]:
        """Windowed aggregates per matching series — the `obs.query`
        channel payload and what `fleet top` renders."""
        since = self.clock() - window_s if window_s else None
        out = []
        for s in self.match(name, labels):
            samples = s.samples(since=since)
            out.append({"name": s.name, "labels": s.labels_dict(),
                        "kind": s.kind, "agg": _aggregate(samples, s.kind)})
        return out

    def aggregate_range(self, since: Optional[float] = None,
                        until: Optional[float] = None,
                        name: Optional[str] = None,
                        labels: Optional[dict] = None) -> list[dict]:
        """Aggregates over an explicit [since, until] interval — a
        benchmark's per-leg summary windows (aggregate() is anchored to
        NOW; a leg that finished minutes ago needs absolute bounds).
        Series with no samples in the interval are omitted."""
        out = []
        for s in self.match(name, labels):
            samples = s.samples(since=since, until=until)
            if not samples:
                continue
            out.append({"name": s.name, "labels": s.labels_dict(),
                        "kind": s.kind, "agg": _aggregate(samples, s.kind)})
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"series": len(self._series),
                    "samples_total": self.samples_total,
                    "dropped_series": self.dropped_series,
                    "capacity_per_series": self.capacity,
                    "max_series": self.max_series}

    # -- capture / export ----------------------------------------------

    def snapshot(self, round_t: int = 6, round_v: int = 9) -> dict:
        """Deterministic-schema capture: sorted series, rounded floats
        (virtual-clock arithmetic is exact, but rounding pins the repr
        across platforms), lifetime totals, and a content digest. The
        chaos runner embeds this in the report and writes it alongside
        the event-log digest."""
        series = []
        for s in self.match():
            series.append({
                "name": s.name,
                "labels": s.labels_dict(),
                "kind": s.kind,
                "total": s.total,
                "samples": [[round(t, round_t), round(v, round_v)]
                            for t, v in s.samples()]})
        snap = {"schema_version": SCHEMA_VERSION,
                "capacity_per_series": self.capacity,
                "series": series}
        snap["digest"] = snapshot_digest(snap)
        return snap

    def render_openmetrics(self) -> str:
        """OpenMetrics-style text dump with explicit timestamps, one
        line per retained sample (`fleet obs export`). This is an
        offline dump format, not the live scrape endpoint — GET /metrics
        stays the registry's job."""
        lines = []
        seen: set[str] = set()
        for s in self.match():
            if s.name not in seen:
                seen.add(s.name)
                kind = "counter" if s.kind == "counter" else "gauge"
                lines.append(f"# TYPE {s.name} {kind}")
            sel = ",".join(f'{k}="{v}"' for k, v in s.labels)
            sel = "{" + sel + "}" if sel else ""
            for t, v in s.samples():
                lines.append(f"{s.name}{sel} {v:g} {t:.6f}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def export_jsonl(self) -> str:
        """One JSON object per series per line — the shape downstream
        notebooks/loaders want (`fleet obs export --format jsonl`)."""
        rows = self.query()
        return "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)


def snapshot_digest(snap: dict) -> str:
    """sha256 over the canonical JSON of a snapshot's series (the
    `digest` key itself excluded so the operation is idempotent)."""
    body = {k: v for k, v in snap.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def iter_registry_samples(snapshot: dict) -> Iterable[tuple]:
    """Flatten a MetricsRegistry.snapshot() into (name, labels, value,
    kind) tuples the TSDB records directly: counters keep their raw
    cumulative value (rate is a query-time aggregate), gauges pass
    through, histograms become `<name>_sum` + `<name>_count` counter
    series (enough to derive windowed averages)."""
    for name, fam in snapshot.items():
        ftype = fam.get("type")
        for v in fam.get("values", ()):
            labels = v.get("labels") or {}
            if ftype == "histogram":
                yield (f"{name}_sum", labels, float(v["sum"]), "counter")
                yield (f"{name}_count", labels, float(v["count"]),
                       "counter")
            elif ftype == "counter":
                yield (name, labels, float(v["value"]), "counter")
            else:
                yield (name, labels, float(v["value"]), "gauge")
