"""Runtime layer (the port's copy of ``fleetflow_tpu/runtime``: the
converter, the container backends, the readiness waiter and the deploy
engine).

The deploy engine consumes a Placement from the scheduler layer and turns
it into ordered container operations against a ContainerBackend (docker
CLI shellout, or the in-memory mock the tests and the card's self-healing
drive use). The reference's Quadlet and Compose generators, the port
probes, the readiness checks and the static-site runtime are not ported
yet (ROADMAP).
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
