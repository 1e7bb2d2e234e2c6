"""SSH host-side wrapper (the port's copy of ``fleetflow_tpu/cloud/ssh.py``).

Analog of fleetflow-cloud ssh.rs:27-93: run a command on a remote host
(batch mode, connect timeout, optional per-exec timeout) and scp a file.
The runner is injectable for tests.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional

from ..core.errors import CloudError

__all__ = ["SshTarget", "exec", "exec_with_timeout", "copy_file"]

CONNECT_TIMEOUT_S = 10
_BASE_OPTS = ["-o", "BatchMode=yes",
              "-o", f"ConnectTimeout={CONNECT_TIMEOUT_S}",
              "-o", "StrictHostKeyChecking=accept-new"]


@dataclass
class SshTarget:
    host: str
    user: Optional[str] = None
    port: int = 22
    key_path: Optional[str] = None

    @property
    def destination(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def common_opts(self) -> list[str]:
        """Options valid for both ssh and scp (port flag differs: -p vs -P)."""
        args = list(_BASE_OPTS)
        if self.key_path:
            args += ["-i", self.key_path]
        return args

    def base_args(self) -> list[str]:
        return self.common_opts() + ["-p", str(self.port)]


def _run(args: list[str], timeout: Optional[float],
         runner=None) -> tuple[int, str, str]:
    if runner is not None:
        return runner(args, timeout)
    try:
        proc = subprocess.run(args, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        raise CloudError(f"ssh timed out after {timeout}s: "
                         f"{' '.join(args[:3])}...") from None
    return proc.returncode, proc.stdout, proc.stderr


def exec(target: SshTarget, command: str, *, runner=None) -> str:
    """ssh.rs exec:27. Raises CloudError on nonzero exit."""
    return exec_with_timeout(target, command, timeout=None, runner=runner)


def exec_with_timeout(target: SshTarget, command: str, *,
                      timeout: Optional[float], runner=None) -> str:
    """ssh.rs exec_with_timeout."""
    args = ["ssh", *target.base_args(), target.destination, command]
    rc, out, err = _run(args, timeout, runner)
    if rc != 0:
        raise CloudError(
            f"ssh {target.destination} failed (rc={rc}): {err.strip() or out.strip()}")
    return out


def copy_file(target: SshTarget, local: str, remote: str, *,
              runner=None) -> None:
    """ssh.rs copy_file:93 (scp; port flag is -P, unlike ssh's -p)."""
    args = ["scp", *target.common_opts(), "-P", str(target.port),
            local, f"{target.destination}:{remote}"]
    rc, out, err = _run(args, None, runner)
    if rc != 0:
        raise CloudError(f"scp to {target.destination} failed: {err.strip()}")
