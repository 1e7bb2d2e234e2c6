"""Zero-dependency, thread-safe metrics registry with Prometheus exposition
(copy of ``fleetflow_tpu/obs/metrics.py``).

Every layer of the port (solver, scheduler, the kernel library) registers
named Counters/Gauges/Histograms against the module-level `REGISTRY`;
``REGISTRY.render()`` is the Prometheus text of the whole set, byte-equal to
the reference's for equal contents (same escaping and number formatting).
No client library, and nothing beyond the standard library: the registry
imports neither torch nor the rest of the package.

Semantics follow the Prometheus client contract where it matters:

- get-or-create: `REGISTRY.counter("x_total", ...)` returns the SAME metric
  on every call; re-registering with a different type or label set raises.
- Counters only go up (`inc(negative)` raises).
- label sets are materialized lazily per label-value tuple; unlabeled
  metrics expose a zero sample from the moment they are defined, so the
  exposition's name/type/HELP surface is stable from import time.
- histograms use cumulative `le` buckets with `+Inf`, `_sum` and `_count`.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_BUCKETS", "MS_BUCKETS", "SOLVE_SECONDS_BUCKETS"]

# tuned for request/solve latencies in seconds: 1ms .. 60s
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# millisecond-valued families (warm-path solver timings, admission drain
# phases): sub-ms through the compile cliff. The dense 1–25 ms run is
# deliberate — the warm-churn regime lives there, and a p50 move from
# 12 → 10 ms must land in different buckets to be visible to rate()/
# histogram_quantile() consumers.
MS_BUCKETS = (0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.5, 10.0, 12.5, 15.0, 20.0,
              25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

# seconds-valued solve histograms with the same ms-scale resolution
# under 25 ms that MS_BUCKETS gives the ms families: the stock
# DEFAULT_BUCKETS jump 10 → 25 ms, which flattens exactly the regime the
# warm path operates in.
SOLVE_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.0075, 0.01, 0.0125,
                         0.015, 0.02, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                         2.5, 5.0, 10.0, 30.0, 60.0)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class _Metric:
    """Base: a named family with a fixed label-name tuple and per-label-value
    children. All mutation goes through one lock per family."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            # eager zero sample: the exposition surface must not depend on
            # whether the code path that first increments has run yet
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _child(self, labels: dict):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children.setdefault(key, self._new_child())
        return child

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{_escape_label(v)}"'
                 for k, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def samples(self) -> Iterable[str]:
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(self.samples())
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def _new_child(self) -> list:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        child = self._child(labels)
        with self._lock:
            child[0] += amount

    def value(self, **labels) -> float:
        child = self._children.get(self._key(labels))
        return child[0] if child is not None else 0.0

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{self._label_str(k)} {_fmt(c[0])}"
                for k, c in items]


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> list:
        return [0.0]

    def set(self, value: float, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child[0] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        child = self._children.get(self._key(labels))
        return child[0] if child is not None else 0.0

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{self._label_str(k)} {_fmt(c[0])}"
                for k, c in items]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        super().__init__(name, help, labelnames)

    def _new_child(self) -> dict:
        return {"counts": [0] * (len(self.buckets) + 1),  # last = +Inf
                "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    idx = i
                    break
            child["counts"][idx] += 1
            child["sum"] += value
            child["count"] += 1

    def count(self, **labels) -> int:
        child = self._children.get(self._key(labels))
        return child["count"] if child is not None else 0

    def sum(self, **labels) -> float:
        child = self._children.get(self._key(labels))
        return child["sum"] if child is not None else 0.0

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted((k, {"counts": list(c["counts"]),
                                "sum": c["sum"], "count": c["count"]})
                           for k, c in self._children.items())
        out = []
        for key, c in items:
            cum = 0
            for b, n in zip((*self.buckets, math.inf), c["counts"]):
                cum += n
                le = f'le="{_fmt(b)}"'
                out.append(
                    f"{self.name}_bucket{self._label_str(key, le)} {cum}")
            out.append(f"{self.name}_sum{self._label_str(key)} "
                       f"{_fmt(c['sum'])}")
            out.append(f"{self.name}_count{self._label_str(key)} "
                       f"{c['count']}")
        return out


class MetricsRegistry:
    """Named metric families; one per process by default (`REGISTRY`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # -- definition (get-or-create) ------------------------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labels)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}")
                return existing
            metric = cls(name, help, labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exposition ----------------------------------------------------
    def render(self) -> str:
        """Prometheus text format, families sorted by name, trailing \\n."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump: {name: {type, help, labels, values}} — the form
        the CP `health.metrics` channel and bench.py artifacts embed."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out: dict = {}
        for m in metrics:
            with m._lock:
                items = sorted(m._children.items())
                if isinstance(m, Histogram):
                    values = [{"labels": dict(zip(m.labelnames, k)),
                               "sum": c["sum"], "count": c["count"]}
                              for k, c in items]
                else:
                    values = [{"labels": dict(zip(m.labelnames, k)),
                               "value": c[0]} for k, c in items]
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labels": list(m.labelnames), "values": values}
        return out

    def counter_values(self) -> dict[str, float]:
        """Flat {name{label="v",...}: value} map of every counter sample —
        what the chaos monotonicity invariant diffs between check points."""
        with self._lock:
            counters = [m for m in self._metrics.values()
                        if isinstance(m, Counter)]
        out: dict[str, float] = {}
        for m in counters:
            with m._lock:
                for k, c in m._children.items():
                    out[f"{m.name}{m._label_str(k)}"] = c[0]
        return out


REGISTRY = MetricsRegistry()
