"""Plan/apply diff model (the port's copy of
``fleetflow_tpu/cloud/action.py``).

Analog of fleetflow-cloud action.rs:8-131: a Plan is an ordered list of
Actions (create/update/delete/noop) produced by diffing desired config
against provider state; ApplyResult records per-action outcomes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["ActionType", "Action", "Plan", "ApplyResult"]


class ActionType(str, enum.Enum):
    CREATE = "create"
    UPDATE = "update"
    DELETE = "delete"
    NOOP = "noop"


@dataclass
class Action:
    """action.rs Action."""
    type: ActionType
    resource_type: str              # "server" | "dns_record" | ...
    resource_id: str
    description: str = ""
    desired: Optional[dict] = None
    current: Optional[dict] = None

    def __str__(self) -> str:
        sym = {"create": "+", "update": "~", "delete": "-", "noop": "="}
        return (f"{sym[self.type.value]} {self.resource_type}/"
                f"{self.resource_id} {self.description}".rstrip())


@dataclass
class Plan:
    """action.rs Plan: what apply would do."""
    provider: str
    actions: list[Action] = field(default_factory=list)

    @property
    def changes(self) -> list[Action]:
        return [a for a in self.actions if a.type != ActionType.NOOP]

    @property
    def empty(self) -> bool:
        return not self.changes

    def summary(self) -> str:
        counts: dict[str, int] = {}
        for a in self.changes:
            counts[a.type.value] = counts.get(a.type.value, 0) + 1
        if not counts:
            return "no changes"
        return ", ".join(f"{v} to {k}" for k, v in sorted(counts.items()))


@dataclass
class ApplyResult:
    """action.rs ApplyResult."""
    succeeded: list[Action] = field(default_factory=list)
    failed: list[tuple[Action, str]] = field(default_factory=list)
    outputs: dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failed
