"""Persisted cloud-resource state tree (the port's copy of
``fleetflow_tpu/cloud/state.py``).

Analog of fleetflow-cloud state.rs:21-169: GlobalState -> ProviderState ->
ResourceState, persisted as JSON under the project's `.fleetflow/state/`
(the reference's terraform-ish local state file), with helpers to diff a
provider's view against it.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

__all__ = ["ResourceState", "ProviderState", "GlobalState"]


@dataclass
class ResourceState:
    """state.rs ResourceState:111."""
    id: str
    type: str
    name: str
    attributes: dict = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"id": self.id, "type": self.type, "name": self.name,
                "attributes": self.attributes,
                "created_at": self.created_at, "updated_at": self.updated_at}

    @classmethod
    def from_dict(cls, d: dict) -> "ResourceState":
        return cls(**d)


@dataclass
class ProviderState:
    """state.rs ProviderState."""
    provider: str
    resources: dict[str, ResourceState] = field(default_factory=dict)

    def by_type(self, rtype: str) -> list[ResourceState]:
        return [r for r in self.resources.values() if r.type == rtype]

    def upsert(self, res: ResourceState) -> None:
        res.updated_at = time.time()
        self.resources[res.id] = res

    def to_dict(self) -> dict:
        return {"provider": self.provider,
                "resources": {k: r.to_dict()
                              for k, r in self.resources.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ProviderState":
        return cls(provider=d["provider"],
                   resources={k: ResourceState.from_dict(v)
                              for k, v in d.get("resources", {}).items()})


@dataclass
class GlobalState:
    """state.rs GlobalState:21."""
    providers: dict[str, ProviderState] = field(default_factory=dict)
    path: Optional[str] = None

    def provider(self, name: str) -> ProviderState:
        if name not in self.providers:
            self.providers[name] = ProviderState(provider=name)
        return self.providers[name]

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, project_root: str = ".") -> "GlobalState":
        path = Path(project_root) / ".fleetflow" / "state" / "cloud.json"
        st = cls(path=str(path))
        if path.is_file():
            try:
                doc = json.loads(path.read_text())
            except json.JSONDecodeError:
                return st
            st.providers = {k: ProviderState.from_dict(v)
                            for k, v in doc.get("providers", {}).items()}
        return st

    def save(self) -> None:
        if not self.path:
            return
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"providers": {k: v.to_dict() for k, v in self.providers.items()}},
            indent=2))
        tmp.replace(p)
