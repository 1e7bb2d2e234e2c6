"""Node agent (L4b): the per-node daemon (the port's copy of
``fleetflow_tpu/agent``).

Analog of fleet-agent (SURVEY.md §2.6): an outer reconnect loop, a
register-first session over the CP protocol, periodic heartbeats, a
container monitor with anomaly detection (restart loops, unexpected stops,
unhealthy containers — with alert cooldown and auto-resolve), and command
executors (deploy/restart/status/build/ping) answering through the
request_id correlation envelope.
"""

from .agent import Agent, AgentConfig
from .monitor import AnomalyDetector, ContainerSnapshot, detect_anomalies

__all__ = ["Agent", "AgentConfig", "AnomalyDetector", "ContainerSnapshot",
           "detect_anomalies"]
