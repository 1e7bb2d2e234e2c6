"""Daemon lifecycle: the fleetflowd binary.

Analog of fleetflowd main.rs:40-202: load config -> PID-file check
(Running/Stale/Stopped) -> start CP protocol server + web REST + health
checker -> run until SIGTERM/SIGINT -> graceful stop.

The control plane places on the card (`DaemonConfig.use_gpu_solver`,
`device`): without CUDA, and unless the config asks for the CPU, `start`
raises DeviceUnavailable before anything listens.
"""

from __future__ import annotations

import asyncio
import signal
from typing import Optional

from ..cp.server import CpServerHandle, ServerConfig, start as cp_start
from .config import DaemonConfig
from .health import HealthChecker
from ..cp.autoscaler import Autoscaler
from .pidfile import PidFile
from .web import WebServer

__all__ = ["Daemon"]


class Daemon:
    def __init__(self, config: DaemonConfig, ready_fd: Optional[int] = None):
        self.config = config
        self.pidfile = PidFile(config.pid_file)
        # write-end of the daemonizer's readiness pipe: one byte after a
        # successful start(); closed-without-write (process death) tells
        # the parent the daemon failed — no pidfile polling race
        self.ready_fd = ready_fd
        self.cp: Optional[CpServerHandle] = None
        self.web: Optional[WebServer] = None
        self.health: Optional[HealthChecker] = None
        self.autoscaler: Optional[Autoscaler] = None
        self.web_addr: Optional[tuple[str, int]] = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        cfg = self.config
        self.cp = await cp_start(ServerConfig(
            host=cfg.listen_host, port=cfg.listen_port,
            db_path=cfg.db_path, auth_kind=cfg.auth_kind,
            auth_secret=cfg.auth_secret, auth_jwks=cfg.auth_jwks,
            auth_issuer=cfg.auth_issuer, auth_audience=cfg.auth_audience,
            auth_client_id=cfg.auth_client_id,
            tls_dir=cfg.tls_dir,
            use_gpu_solver=cfg.use_gpu_solver, device=cfg.device,
            self_heal=cfg.self_heal, lease_s=cfg.lease_s,
            suspect_grace_s=cfg.suspect_grace_s,
            heal_interval_s=cfg.heal_interval_s,
            standby_of=cfg.standby_of,
            standby_token=cfg.standby_token,
            standby_ping_interval_s=cfg.standby_ping_interval_s,
            standby_lease_s=cfg.standby_lease_s,
            standby_grace_s=cfg.standby_grace_s,
            admission=cfg.admission,
            admission_queue=cfg.admission_queue,
            admission_batch=cfg.admission_batch,
            admission_shed_age_s=cfg.admission_shed_age_s,
            slo=dict(cfg.slo)))
        if cfg.web_enabled:
            self.web = WebServer(self.cp.state)
            self.web_addr = await self.web.start(cfg.web_host, cfg.web_port)
        self.health = HealthChecker(self.cp.state,
                                    interval_s=cfg.health_interval_s,
                                    stale_after_s=cfg.heartbeat_stale_s,
                                    use_tailscale=cfg.health_tailscale)
        self.health.spawn()
        if cfg.autoscale_interval_s > 0:
            self.autoscaler = Autoscaler(
                self.cp.state, interval_s=cfg.autoscale_interval_s)
            self.autoscaler.spawn()

    async def stop(self) -> None:
        if self.autoscaler:
            self.autoscaler.stop()
        if self.health:
            self.health.stop()
        if self.web:
            await self.web.stop()
        if self.cp:
            await self.cp.stop()
        self._stop.set()

    async def run_forever(self) -> None:
        """PID-guarded run with signal handling (main.rs:173-202)."""
        self.pidfile.acquire()
        try:
            await self.start()
            if self.ready_fd is not None:
                import os
                try:
                    os.write(self.ready_fd, b"ok")
                    os.close(self.ready_fd)
                except OSError:
                    pass
                self.ready_fd = None
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(
                        sig, lambda: asyncio.ensure_future(self.stop()))
                except NotImplementedError:
                    pass
            await self._stop.wait()
        finally:
            self.pidfile.release()
