"""One-shot post-start readiness probes.

Analog of the reference's `fleet up` readiness pass (up.rs:444-505): after
containers start, each service declaring `readiness{}` is polled over HTTP
on its published host port until it answers or its timeout lapses. This is
distinct from the dependency waiter (waiter.py, which gates deploy WAVES on
container health): readiness is a final user-facing "your service actually
answers" report, and a failure marks the service not-ready without tearing
the stage down.

The prober is injectable (tests run without sockets).

The port's copy of ``fleetflow_tpu/runtime/readiness.py``.
"""

from __future__ import annotations

import socket
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.model import Service
from ..obs import get_logger, kv

__all__ = ["ReadinessResult", "check_readiness", "run_readiness_checks"]

log = get_logger("readiness")


class _NotReady(Exception):
    """HTTP answered outside the 2xx/3xx window (carries the status)."""


@dataclass
class ReadinessResult:
    service: str
    ready: bool
    url: str = ""
    attempts: int = 0
    detail: str = ""


def _default_fetch(url: str, timeout: float) -> int:
    """GET the url, return the HTTP status (raises on transport errors)."""
    req = urllib.request.Request(url, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def check_readiness(svc: Service, *, fetch=None,
                    sleep: Callable[[float], None] = time.sleep,
                    clock: Callable[[], float] = time.monotonic,
                    host: str = "127.0.0.1") -> Optional[ReadinessResult]:
    """Poll one service's readiness endpoint. Returns None when the service
    declares no readiness check (or no resolvable port)."""
    rc = svc.readiness
    if rc is None:
        return None
    fetch = fetch or _default_fetch
    port = rc.port
    if port is None and svc.ports:
        port = svc.ports[0].host
    if port is None:
        return ReadinessResult(svc.name, False, detail="no port to probe")
    kind = (rc.type or "http").lower()
    if kind == "tcp":
        url = f"tcp://{host}:{port}"

        def probe(timeout):
            with socket.create_connection((host, port), timeout=timeout):
                return True
    elif kind == "http":
        path = rc.path if rc.path.startswith("/") else f"/{rc.path}"
        url = f"http://{host}:{port}{path}"

        def probe(timeout):
            status = fetch(url, timeout)
            if 200 <= status < 400:
                return True
            raise _NotReady(f"HTTP {status}")
    else:
        return ReadinessResult(svc.name, False,
                               detail=f"unsupported readiness type {kind!r}")

    deadline = clock() + rc.timeout
    attempts = 0
    detail = ""
    while True:
        attempts += 1
        try:
            if probe(min(rc.interval * 2, 5.0)):
                log.debug("ready %s", kv(service=svc.name, url=url,
                                         attempts=attempts))
                return ReadinessResult(svc.name, True, url, attempts)
        except Exception as e:
            detail = str(e) or type(e).__name__
        if clock() >= deadline:
            log.warning("not ready %s", kv(service=svc.name, url=url,
                                           attempts=attempts, detail=detail))
            return ReadinessResult(svc.name, False, url, attempts, detail)
        sleep(rc.interval)


def run_readiness_checks(services: list[Service],
                         on_line: Callable[[str], None] = lambda s: None,
                         **kw) -> list[ReadinessResult]:
    """Probe every service that declares readiness; report each outcome."""
    results = []
    for svc in services:
        res = check_readiness(svc, **kw)
        if res is None:
            continue
        mark = "✓" if res.ready else "✗"
        tail = "" if res.ready else f" ({res.detail})"
        on_line(f"  {mark} {svc.name} {res.url}{tail}")
        results.append(res)
    return results
