"""Control plane (the port's copy of ``fleetflow_tpu.cp``, its placement
path): the store, the placement service that solves a stage against the
store's live server inventory on the card, and the streaming admission
controller in front of its warm micro-solves.

The protocol server (``start``, ``AppState``, ``ServerConfig``), the agent
registry, the failure detector and the reconverger are not ported yet
(ROADMAP).
"""

from .admission import AdmissionController
from .placement import PlacementService
from .store import Store

__all__ = ["AdmissionController", "PlacementService", "Store"]
