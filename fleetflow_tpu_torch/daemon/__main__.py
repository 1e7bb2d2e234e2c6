"""`python -m fleetflow_tpu_torch.daemon` — run the control-plane daemon.

The fleetflowd binary analog (main.rs:40): flags mirror the reference's
(config path, foreground run; `stop`/`status` subcommands act on the PID
file).

The daemon places on the card. A daemon that cannot start (no CUDA, a
port taken) writes its error down the readiness pipe, and `start` prints
it beside the pointer to the log.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from .config import load_daemon_config
from .daemon import Daemon
from .pidfile import PidFile, PidStatus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fleetflowd",
                                 description="fleetflow-tpu control-plane daemon")
    ap.add_argument("command", nargs="?", default="run",
                    choices=["run", "start", "stop", "status"])
    ap.add_argument("-c", "--config", help="path to fleetflowd.kdl")
    args = ap.parse_args(argv)

    cfg = load_daemon_config(args.config)
    ready_fd = None   # set when daemonizing via `start`

    if args.command == "start":
        # DaemonCommands::Start: POSIX double-fork detach — the second fork
        # drops session leadership so the daemon can never reacquire a
        # controlling terminal
        st, pid = PidFile(cfg.pid_file).status()
        if st is PidStatus.RUNNING:
            print(f"already running (pid {pid})")
            return 1
        # readiness pipe: the grandchild writes one byte AFTER its sockets
        # bound; pipe EOF without the byte means it died. This is race-free
        # (ADVICE r2: the parent used to exit 0 right after the fork; a
        # pidfile poll instead would race the acquire-before-bind window)
        # and fails fast — a dead daemon closes the pipe immediately
        # instead of burning a fixed poll budget.
        ready_r, ready_w = os.pipe()
        child = os.fork()
        if child > 0:
            os.close(ready_w)
            os.waitpid(child, 0)   # reap the intermediate immediately
            import select
            readable, _, _ = select.select([ready_r], [], [], 30.0)
            data = os.read(ready_r, 8192) if readable else b""
            os.close(ready_r)
            if data == b"ok":
                _, pid = PidFile(cfg.pid_file).status()
                print(f"started fleetflowd (pid {pid})")
                return 0
            print("fleetflowd failed to start"
                  + (f" (see {cfg.log_file})" if cfg.log_file
                     else " (set log-file in fleetflowd.kdl for details)"),
                  file=sys.stderr)
            if data.startswith(_ERR):
                print(data.decode("utf-8", "replace"), file=sys.stderr)
            return 1
        os.close(ready_r)
        os.setsid()
        grandchild = os.fork()
        if grandchild > 0:
            os._exit(0)            # intermediate exits; daemon reparents
        # the grandchild is the daemon; stdio detaches from the terminal
        log = open(cfg.log_file or os.devnull, "a")
        devnull = open(os.devnull, "r")
        os.dup2(devnull.fileno(), 0)
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        args.command = "run"
        ready_fd = ready_w

    if args.command == "status":
        st, pid = PidFile(cfg.pid_file).status()
        print(f"{st.value}" + (f" (pid {pid})" if pid else ""))
        return 0 if st is PidStatus.RUNNING else 1

    if args.command == "stop":
        st, pid = PidFile(cfg.pid_file).status()
        if st is not PidStatus.RUNNING:
            print("not running")
            return 1
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to {pid}")
        return 0

    daemon = Daemon(cfg, ready_fd=ready_fd)

    async def run():
        await daemon.run_forever()

    print(f"fleetflowd: cp on {cfg.listen_host}:{cfg.listen_port}"
          + (f", web on http://{cfg.web_host}:{cfg.web_port}"
             if cfg.web_enabled else "")
          + (f", config {cfg.source}" if cfg.source else " (defaults)"))
    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    except Exception as e:
        # a daemonized start that failed before it was ready: the parent
        # prints the error (the daemon's stderr is its log file)
        if ready_fd is not None and daemon.ready_fd is not None:
            try:
                # one write below PIPE_BUF: the parent's one read gets it
                os.write(ready_fd, (_ERR + f"{type(e).__name__}: {e}"
                                    .encode("utf-8", "replace"))[:4000])
            except OSError:
                pass
        raise
    return 0


_ERR = b"error: "


if __name__ == "__main__":
    sys.exit(main())
