"""Cloud/infra abstraction (the port's copy of ``fleetflow_tpu/cloud``,
the part the control plane's autoscaler and the chaos world need).

The declarative `CloudProvider` plan/apply trait and the imperative
`ServerProvider` CRUD trait, the Plan/Action diff model and the persisted
resource-state tree. The concrete providers (sakura, cloudflare, aws) and
the ssh / tailscale wrappers are not ported yet: nothing registers at
import, and `get_provider` knows only what a caller registers.
"""

from .action import Action, ActionType, ApplyResult, Plan
from .provider import (CloudProvider, ServerProvider, ServerInfo,
                       get_provider, provider_names, register_provider)
from .state import GlobalState, ProviderState, ResourceState

__all__ = ["Action", "ActionType", "ApplyResult", "Plan",
           "CloudProvider", "ServerProvider", "ServerInfo",
           "get_provider", "provider_names", "register_provider",
           "GlobalState", "ProviderState", "ResourceState"]
