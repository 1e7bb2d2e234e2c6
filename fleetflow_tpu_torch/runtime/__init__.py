"""Runtime layer (L1; the port's copy of ``fleetflow_tpu/runtime``):
execution engines.

The deploy engine consumes a Placement from the scheduler layer and turns
it into ordered container operations against a ContainerBackend (docker
CLI shellout, or the in-memory mock the tests and the card's self-healing
drive use). The Quadlet (`quadlet.py`) and Compose (`compose.py`)
generators are pure functions, testable without any runtime, beside the
host-port probe (`ports.py`), the readiness checks (`readiness.py`) and
the static-site runtime (`static_site.py`); the node agent executes its
stages through them.
"""

from .converter import ContainerConfig, container_name, network_name, \
    service_to_container_config, stage_services
from .backend import ContainerBackend, ContainerInfo, MockBackend, DockerCliBackend
from .waiter import wait_for_service, check_container_health
from .engine import DeployEngine, DeployRequest, DeployEvent, DeployResult

__all__ = [
    "ContainerConfig", "container_name", "network_name",
    "service_to_container_config", "stage_services",
    "ContainerBackend", "ContainerInfo", "MockBackend", "DockerCliBackend",
    "wait_for_service", "check_container_health",
    "DeployEngine", "DeployRequest", "DeployEvent", "DeployResult",
]
