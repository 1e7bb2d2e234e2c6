"""PID-file daemon lifecycle.

Analog of fleetflowd main.rs:98-114: Running / Stale / Stopped detection
(stale = pid file exists but the process is gone — recovered by overwrite,
main.rs:107-110), atomic write, and owner-checked removal.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path

__all__ = ["PidStatus", "PidFile"]


class PidStatus(enum.Enum):
    RUNNING = "running"
    STALE = "stale"
    STOPPED = "stopped"


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class PidFile:
    def __init__(self, path: str):
        self.path = Path(path)

    def status(self) -> tuple[PidStatus, int]:
        """(status, pid). pid is 0 when STOPPED."""
        try:
            pid = int(self.path.read_text().strip())
        except (OSError, ValueError):
            return PidStatus.STOPPED, 0
        return (PidStatus.RUNNING if _alive(pid) else PidStatus.STALE), pid

    def acquire(self) -> None:
        """Claim the pid file; stale files are overwritten
        (main.rs:107-110), a live owner is an error."""
        st, pid = self.status()
        if st is PidStatus.RUNNING:
            raise RuntimeError(f"daemon already running (pid {pid})")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(str(os.getpid()))
        tmp.replace(self.path)

    def release(self) -> None:
        """Remove only if we own it."""
        st, pid = self.status()
        if pid == os.getpid():
            try:
                self.path.unlink()
            except OSError:
                pass
