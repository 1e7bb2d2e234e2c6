"""Auth providers (the port's copy of ``fleetflow_tpu/cp/auth.py``, the
part the control plane's state and the chaos world need).

Analog of controlplane auth.rs:17-38: an enum-dispatched provider. The
port holds NoAuth (local/dev: everything is the anonymous admin), the
Claims it returns and AuthError. TokenAuth (self-issued HS256), JwksAuth
(RS256 against a cached JWKS document) and `make_provider` come with the
protocol server's `start`, which selects among them; they are not ported
yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.errors import ControlPlaneError

__all__ = ["AuthError", "Claims", "NoAuth"]


class AuthError(ControlPlaneError):
    pass



@dataclass
class Claims:
    """auth.rs Claims: subject email + permission strings."""
    sub: str = ""
    email: str = ""
    permissions: list[str] = field(default_factory=list)
    tenant: str = "default"
    exp: float = 0.0

    def has(self, perm: str) -> bool:
        """Permission check: exact grant, `admin:all`, or a verb wildcard
        (`read:*` satisfies any `read:<area>`)."""
        if perm in self.permissions or "admin:all" in self.permissions:
            return True
        verb, _, _area = perm.partition(":")
        return f"{verb}:*" in self.permissions


class NoAuth:
    """auth.rs NoAuth: everything is the anonymous admin."""

    def verify(self, token: Optional[str]) -> Claims:
        return Claims(sub="anonymous", email="anonymous@local",
                      permissions=["admin:all"], exp=time.time() + 3600)

    def issue(self, email: str, permissions: list[str],
              tenant: str = "default", ttl_s: float = 86400.0) -> str:
        return ""

