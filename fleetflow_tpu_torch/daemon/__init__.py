"""CP daemon (L4a): the fleetflowd analog.

KDL daemon config with a search chain, PID-file lifecycle
(running/stale/stopped), a REST + dashboard web surface over the CP's
AppState, and a background health checker that feeds node churn into the
placement service (SURVEY.md §2.5).
"""

from .config import DaemonConfig, load_daemon_config
from .pidfile import PidFile, PidStatus
from .daemon import Daemon

__all__ = ["DaemonConfig", "load_daemon_config", "PidFile", "PidStatus",
           "Daemon"]
