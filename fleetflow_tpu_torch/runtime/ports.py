"""Host-port conflict resolution.

Analog of fleetflow-container port.rs:9-61: find the PIDs bound to a host
TCP port (via /proc/net/tcp* + /proc/*/fd socket-inode matching — no lsof
dependency), optionally terminate them SIGTERM -> SIGKILL, and
`ensure_port_available` for pre-deploy cleanup.

The port's copy of ``fleetflow_tpu/runtime/ports.py``.
"""

from __future__ import annotations

import os
import signal
import time
from pathlib import Path

__all__ = ["pids_bound_to_port", "kill_pids", "ensure_port_available"]

_LISTEN = "0A"  # TCP_LISTEN in /proc/net/tcp hex state


def _listening_inodes(port: int) -> set[str]:
    inodes: set[str] = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            lines = Path(table).read_text().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split()
            if len(parts) < 10:
                continue
            local, state, inode = parts[1], parts[3], parts[9]
            if state != _LISTEN:
                continue
            try:
                if int(local.rsplit(":", 1)[1], 16) == port:
                    inodes.add(inode)
            except (ValueError, IndexError):
                continue
    return inodes


def pids_bound_to_port(port: int) -> list[int]:
    """PIDs with a listening socket on `port` (port.rs:9)."""
    inodes = _listening_inodes(port)
    if not inodes:
        return []
    targets = {f"socket:[{i}]" for i in inodes}
    pids = []
    for p in Path("/proc").iterdir():
        if not p.name.isdigit():
            continue
        fd_dir = p / "fd"
        try:
            for fd in fd_dir.iterdir():
                try:
                    if os.readlink(fd) in targets:
                        pids.append(int(p.name))
                        break
                except OSError:
                    continue
        except OSError:
            continue
    return pids


def kill_pids(pids: list[int], *, grace_s: float = 3.0,
              sleep=time.sleep) -> None:
    """SIGTERM, wait up to grace_s, then SIGKILL survivors (port.rs:30)."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            continue
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        alive = [pid for pid in pids if _alive(pid)]
        if not alive:
            return
        sleep(0.1)
    for pid in pids:
        if _alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def ensure_port_available(port: int, *, kill: bool = False) -> bool:
    """True if the port is free (after optional cleanup, port.rs:61)."""
    pids = pids_bound_to_port(port)
    if not pids:
        return True
    if not kill:
        return False
    kill_pids(pids)
    return not pids_bound_to_port(port)
