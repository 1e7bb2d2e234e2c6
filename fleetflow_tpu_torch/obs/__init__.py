"""Structured logging, metrics, and trace correlation (port of
``fleetflow_tpu/obs``).

- `get_logger("solver")` returns a named logger under the `fleetflow.`
  namespace (the reference's names, so one FLEET_LOG spec reaches both
  packages), configured once from the `FLEET_LOG` environment variable.
- `span(log, "deploy", stage="live")` is a context manager that logs
  entry at DEBUG, exit at the span's level with a duration, and failures
  at ERROR with the exception — one line per event, `key=value` fields.
  Every span carries a contextvar trace_id/span_id (obs.trace): ids are
  minted on entry when absent, rendered by `kv()` into every log line
  inside the span, and — when `FLEET_TRACE_FILE` is set — recorded as
  begin/end/fail JSONL events in the flight recorder.
- `obs.metrics.REGISTRY` is the port's process-wide metrics registry
  (Counter/Gauge/Histogram, Prometheus text via ``REGISTRY.render()``).
- `profile_trace()` wraps a block in ``torch.profiler.profile`` when
  `FLEET_PROFILE_DIR` is set (opt-in, zero cost otherwise) and writes a
  Chrome trace of it into that directory (chrome://tracing or Perfetto).

`FLEET_LOG` grammar (tracing-subscriber EnvFilter analog, simplified):
    FLEET_LOG=debug                    # everything under fleetflow.* at DEBUG
    FLEET_LOG=info,solver=debug        # default INFO, fleetflow.solver DEBUG
    FLEET_LOG=engine=debug,cp=warning  # per-module levels, rest untouched
Levels: trace (5, below DEBUG — registered via logging.addLevelName),
debug, info, warn[ing], error, off. Unset/empty leaves the `fleetflow`
logger un-configured (library mode: the host application owns logging
config, handlers propagate as usual).

Both this package and ``fleetflow_tpu`` log under `fleetflow`, and each
keeps its own "configured" flag. So that a process importing both prints
each line once, :func:`configure` adds no handler while the `fleetflow`
logger already holds one that a `configure` installed (either package's);
``force=True`` still replaces the handler set.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from typing import Iterator, Optional

from . import metrics  # noqa: F401  (re-export: obs.metrics.REGISTRY)
from .metrics import REGISTRY
from .trace import (_span_id, _trace_id, _use_span, current_span_id,
                    current_trace_id, new_span_id, new_trace_id,
                    record_span_event, use_trace)

__all__ = ["get_logger", "span", "configure", "profile_trace", "kv",
           "TRACE", "REGISTRY", "metrics", "use_trace", "new_trace_id",
           "current_trace_id", "current_span_id"]

_ROOT = "fleetflow"
_configured = False
# the line format of a configured handler (the reference's, byte for byte:
# it is also how a handler the reference's configure installed is known)
_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"

# A real TRACE level below DEBUG, so FLEET_LOG=solver=trace is
# distinguishable from solver=debug
TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}


def kv(**fields) -> str:
    """Render key=value fields the way the reference's tracing output does.
    Values containing whitespace are quoted; None fields are dropped.
    Inside an active trace (obs.use_trace / span), trace=/span= ids are
    appended so every line of one operation grep-correlates."""
    tid = _trace_id.get()
    if tid and "trace" not in fields:
        fields["trace"] = tid
        sid = _span_id.get()
        if sid and "span" not in fields:
            fields["span"] = sid
    parts = []
    for k, v in fields.items():
        if v is None:
            continue
        s = str(v)
        if any(c.isspace() for c in s) or s == "":
            s = repr(s)
        parts.append(f"{k}={s}")
    return " ".join(parts)


def _configure_handler(h: logging.Handler) -> bool:
    """Was `h` installed by a `configure` (this package's or the
    reference's)?"""
    if getattr(h, "_fleet_configured", False):
        return True
    fmt = getattr(h.formatter, "_fmt", None)
    return type(h) is logging.StreamHandler and fmt == _FORMAT


def configure(spec: Optional[str] = None, *, force: bool = False,
              stream=None) -> None:
    """Apply a FLEET_LOG spec to the `fleetflow` logger tree. Called lazily
    by get_logger(); call directly (force=True) to re-apply after mutating
    the environment (tests do this)."""
    global _configured
    if _configured and not force:
        return
    _configured = True
    if spec is None:
        spec = os.environ.get("FLEET_LOG", "")
    spec = (spec or "").strip()
    if not spec:
        return

    root = logging.getLogger(_ROOT)
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    if not any(_configure_handler(h) for h in root.handlers):
        handler = logging.StreamHandler(stream)  # None -> stderr
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        handler._fleet_configured = True  # type: ignore[attr-defined]
        root.addHandler(handler)
    root.propagate = False

    default_level = None
    per_module: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            mod, _, lvl = part.partition("=")
            level = _LEVELS.get(lvl.strip().lower())
            if level is not None:
                per_module[mod.strip()] = level
        else:
            default_level = _LEVELS.get(part.lower())
    root.setLevel(default_level if default_level is not None else logging.INFO)
    for mod, level in per_module.items():
        logging.getLogger(f"{_ROOT}.{mod}").setLevel(level)


def get_logger(name: str) -> logging.Logger:
    """Named logger under the fleetflow namespace: get_logger('engine') ->
    `fleetflow.engine`. First call applies FLEET_LOG."""
    configure()
    return logging.getLogger(f"{_ROOT}.{name}")


@contextlib.contextmanager
def span(log: logging.Logger, name: str, level: int = logging.INFO,
         **fields) -> Iterator[dict]:
    """Timed span: DEBUG on entry, `level` with duration_ms on exit, ERROR
    with the exception on failure. The yielded dict collects extra fields to
    report at exit (span['placed'] = 12).

    Trace correlation: joins the active trace (minting a trace_id when none
    is active), mints a span_id, and records the enclosing span as parent.
    The ids render via kv() in the span's own lines and every kv() line
    inside its body, and land in the flight recorder when FLEET_TRACE_FILE
    is set."""
    extra: dict = {}
    parent = _span_id.get()
    sid = new_span_id()
    with use_trace() as tid, _use_span(sid):
        head = kv(**fields)
        log.debug("%s started%s", name, f" {head}" if head else "")
        record_span_event("begin", name, log.name, trace=tid, span=sid,
                          parent=parent, fields=fields or None)
        t0 = time.perf_counter()
        try:
            yield extra
        except Exception as e:
            ms = (time.perf_counter() - t0) * 1e3
            log.error("%s failed %s", name,
                      kv(duration_ms=f"{ms:.1f}", error=e, **fields, **extra))
            record_span_event("fail", name, log.name, trace=tid, span=sid,
                              parent=parent, duration_ms=ms, error=str(e),
                              fields={**fields, **extra} or None)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        log.log(level, "%s %s", name,
                kv(duration_ms=f"{ms:.1f}", **fields, **extra))
        record_span_event("end", name, log.name, trace=tid, span=sid,
                          parent=parent, duration_ms=ms,
                          fields={**fields, **extra} or None)


_trace_seq = itertools.count()


@contextlib.contextmanager
def profile_trace(label: str = "solve", device=None) -> Iterator[None]:
    """Opt-in torch.profiler trace: active only when FLEET_PROFILE_DIR is
    set, and then the block runs under ``torch.profiler.profile`` (CPU
    activity, and CUDA activity when `device` is a CUDA device) inside a
    ``record_function(label)`` range; on exit a Chrome trace,
    ``<label>.<pid>.<n>.pt.trace.json``, is written into the directory.
    `device` may be a zero-argument callable, called only when the trace
    is on. torch.profiler does not nest: never set FLEET_PROFILE_DIR
    around code that another profiler is already tracing."""
    prof_dir = os.environ.get("FLEET_PROFILE_DIR", "")
    if not prof_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if callable(device):
        device = device()
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(prof_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
    prof.export_chrome_trace(os.path.join(
        prof_dir, f"{label}.{os.getpid()}.{next(_trace_seq)}.pt.trace.json"))
