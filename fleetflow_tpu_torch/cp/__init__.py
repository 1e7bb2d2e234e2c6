"""Control plane (the port's copy of ``fleetflow_tpu.cp``).

Analog of fleetflow-controlplane (SURVEY.md §2.4): a store, channel-based
wire protocol, agent registry with request-id correlation, log router,
auth, mesh CA, secret crypto, and the channel handlers — plus the piece
the reference doesn't have: a placement service that solves a stage
against the store's live server inventory on the card, the streaming
admission controller in front of its warm micro-solves, and the failure
detector and reconverger that turn dead verdicts into churn re-solves on
the card and redeploys on the surviving agents.

Transport: asyncio TCP with length-prefixed JSON frames, optionally
wrapped in TLS from a private mesh CA (cp/cert.py) — the reference's
protocol, so either package's client talks to the other's server.
``start(ServerConfig(...))`` serves it; its placement solves on the card
unless ``ServerConfig.device`` or ``use_gpu_solver=False`` says otherwise.
"""

from .admission import AdmissionController
from .placement import PlacementService
from .server import AppState, CpServerHandle, ServerConfig, start
from .store import Store

__all__ = ["start", "AdmissionController", "AppState", "CpServerHandle",
           "PlacementService", "ServerConfig", "Store"]
