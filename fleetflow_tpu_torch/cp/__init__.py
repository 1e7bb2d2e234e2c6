"""Control plane (the port's copy of ``fleetflow_tpu.cp``, its placement
and self-healing paths): the store, the placement service that solves a
stage against the store's live server inventory on the card, the
streaming admission controller in front of its warm micro-solves, the
wire protocol, the agent registry and its shard table, the failure
detector and the reconverger that turns its dead verdicts into churn
re-solves on the card and redeploys on the surviving agents.

The protocol server's application (``start``, ``AppState``,
``ServerConfig``) is not ported yet (ROADMAP).
"""

from .admission import AdmissionController
from .placement import PlacementService
from .store import Store

__all__ = ["AdmissionController", "PlacementService", "Store"]
