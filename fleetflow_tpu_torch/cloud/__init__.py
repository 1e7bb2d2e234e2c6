"""Cloud/infra abstraction (the port's copy of ``fleetflow_tpu/cloud``).

Analog of fleetflow-cloud (SURVEY.md §2.7): the declarative
`CloudProvider` plan/apply trait and imperative `ServerProvider` CRUD
trait, the Plan/Action diff model, the persisted resource-state tree, and
the ssh / tailscale host-side wrappers. Concrete providers (sakura via
usacloud, cloudflare via REST/wrangler, aws) register through
`register_provider`; each shells out to its CLI and is stubbed cleanly
when the binary is absent.
"""

from .action import Action, ActionType, ApplyResult, Plan
from .provider import (CloudProvider, ServerProvider, ServerInfo,
                       get_provider, provider_names, register_provider)
from .state import GlobalState, ProviderState, ResourceState

__all__ = ["Action", "ActionType", "ApplyResult", "Plan",
           "CloudProvider", "ServerProvider", "ServerInfo",
           "get_provider", "provider_names", "register_provider",
           "GlobalState", "ProviderState", "ResourceState"]

# built-in providers self-register on import
from . import sakura as _sakura       # noqa: E402,F401
from . import cloudflare as _cf       # noqa: E402,F401
from . import aws as _aws             # noqa: E402,F401
