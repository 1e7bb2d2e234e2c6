"""Trace correlation + the flight recorder (copy of
``fleetflow_tpu/obs/trace.py``).

The span half of `obs` times individual operations; this module ties them
together: a contextvar-carried `trace_id` follows one logical operation (a
deploy, a solve, a CLI invocation) across modules, threads and — via
`DeployRequest.trace_id` on the CP->agent wire — across machines, and an
opt-in JSON-lines sink (`FLEET_TRACE_FILE`) records every span begin/end/
fail event with durations, so a single `fleet deploy` can be replayed as a
timeline afterwards (`fleet events --trace-file`).

Contextvars propagate through async/await but NOT into
`loop.run_in_executor` threads; code that hops threads re-enters the trace
explicitly from the id it carried (`with use_trace(req.trace_id): ...`),
which is exactly what DeployEngine.execute does.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Iterator, Optional

__all__ = ["new_trace_id", "new_span_id", "current_trace_id",
           "current_span_id", "use_trace", "FlightRecorder",
           "flight_recorder", "record_span_event", "read_trace_file",
           "read_trace_files"]

_trace_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "fleet_trace_id", default="")
_span_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "fleet_span_id", default="")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


def current_trace_id() -> str:
    """The active trace id, or '' outside any trace."""
    return _trace_id.get()


def current_span_id() -> str:
    return _span_id.get()


@contextlib.contextmanager
def use_trace(trace_id: Optional[str] = None) -> Iterator[str]:
    """Enter a trace context: adopt `trace_id`, keep the already-active
    trace when none is given, or mint a fresh id. Restores the previous
    context on exit, so nested/sequential operations cannot leak ids into
    each other."""
    tid = trace_id or _trace_id.get() or new_trace_id()
    token = _trace_id.set(tid)
    try:
        yield tid
    finally:
        _trace_id.reset(token)


@contextlib.contextmanager
def _use_span(span_id: str) -> Iterator[str]:
    """Internal: obs.span() sets the current span id for its body."""
    token = _span_id.set(span_id)
    try:
        yield span_id
    finally:
        _span_id.reset(token)


# --------------------------------------------------------------------------
# flight recorder: JSONL span events
# --------------------------------------------------------------------------

class FlightRecorder:
    """Append-only JSON-lines sink for span events. One line per event:

        {"ts": ..., "kind": "begin"|"end"|"fail"|"telemetry",
         "name": ..., "logger": ..., "trace": ..., "span": ...,
         "parent": ..., "duration_ms": ...?, "error": ...?,
         "fields": {...}?}

    Thread-safe (one lock around write+flush); line-buffered so a crashed
    process leaves at most one torn final line, which readers skip.

    Rotation: ``FLEET_TRACE_MAX_MB`` (unset/0 = unbounded) caps the file
    size with a keep-1 rollover — when the next line would cross the
    cap, the current file atomically becomes ``<path>.1`` (replacing any
    previous generation) and a fresh file starts. The admission bench's
    hours of micro-solve spans can no longer grow the recorder without
    bound, and rotation happens BETWEEN lines so both generations stay
    well-formed JSONL; readers span the boundary via
    :func:`read_trace_files`."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = None

    @staticmethod
    def _max_bytes() -> int:
        """Rotation cap, re-read per record so tests (and operators
        adjusting a live process) see the change without a restart."""
        raw = os.environ.get("FLEET_TRACE_MAX_MB", "").strip()
        try:
            mb = float(raw) if raw else 0.0
        except ValueError:
            mb = 0.0
        return int(mb * 1024 * 1024) if mb > 0 else 0

    def _open_locked(self):
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        return self._f

    def record(self, event: dict) -> None:
        line = json.dumps(event, default=str) + "\n"
        cap = self._max_bytes()
        with self._lock:
            f = self._open_locked()
            if cap and f.tell() > 0 and f.tell() + len(line) > cap:
                # keep-1 rollover: the full generation becomes .1
                # (atomic replace of the previous one), a fresh file
                # continues the stream
                f.close()
                self._f = None
                os.replace(self.path, self.path + ".1")
                f = self._open_locked()
            f.write(line)
            f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_recorder() -> Optional[FlightRecorder]:
    """The process-wide recorder for FLEET_TRACE_FILE, or None when the
    env var is unset. Re-resolved on every call so tests (and operators
    toggling the env between operations) get the path they asked for."""
    global _recorder
    path = os.environ.get("FLEET_TRACE_FILE", "").strip()
    if not path:
        return None
    with _recorder_lock:
        if _recorder is None or _recorder.path != path:
            if _recorder is not None:
                _recorder.close()
            _recorder = FlightRecorder(path)
        return _recorder


def record_span_event(kind: str, name: str, logger: str, *,
                      trace: str, span: str, parent: str = "",
                      duration_ms: Optional[float] = None,
                      error: Optional[str] = None,
                      fields: Optional[dict] = None) -> None:
    """Write one span event if the flight recorder is active; no-op (and
    near-free: one env lookup) otherwise."""
    rec = flight_recorder()
    if rec is None:
        return
    event: dict = {"ts": round(time.time(), 6), "kind": kind, "name": name,
                   "logger": logger, "trace": trace, "span": span}
    if parent:
        event["parent"] = parent
    if duration_ms is not None:
        event["duration_ms"] = round(duration_ms, 3)
    if error is not None:
        event["error"] = error
    if fields:
        event["fields"] = fields
    rec.record(event)


def read_trace_files(path: str) -> list[dict]:
    """Read a flight-recorder stream ACROSS the keep-1 rollover: the
    rotated generation (`<path>.1`, if present) followed by the live
    file — a span whose begin predates the rollover and whose end
    followed it reads back whole. The viewers (`fleet events`,
    `fleet solve trace`) use this; :func:`read_trace_file` stays the
    single-file primitive."""
    out: list[dict] = []
    rotated = path + ".1"
    if os.path.exists(rotated):
        out.extend(read_trace_file(rotated))
    out.extend(read_trace_file(path))
    return out


def read_trace_file(path: str) -> list[dict]:
    """Parse a flight-recorder file; a torn final line (crash mid-append)
    is skipped, an undecodable line elsewhere raises."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    for i, ln in enumerate(lines):
        try:
            out.append(json.loads(ln))
        except ValueError:
            if i == len(lines) - 1:
                break
            raise
    return out
