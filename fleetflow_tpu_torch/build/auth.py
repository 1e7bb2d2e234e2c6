"""Registry authentication.

Analog of fleetflow-build auth.rs:43-84: read credentials from
~/.docker/config.json (`auths` entries with base64 `auth` or split
username/password; Docker Hub aliases normalized) for push operations.
Credential helpers are reported, not executed.

The port's copy of ``fleetflow_tpu/build/auth.py``.
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

__all__ = ["RegistryAuth", "registry_for_image", "load_docker_config"]

DOCKER_HUB_ALIASES = {"docker.io", "index.docker.io",
                      "https://index.docker.io/v1/", "registry-1.docker.io"}


@dataclass
class RegistryAuth:
    registry: str
    username: Optional[str] = None
    password: Optional[str] = None
    identity_token: Optional[str] = None
    cred_helper: Optional[str] = None

    @property
    def resolved(self) -> bool:
        return bool(self.username or self.identity_token or self.cred_helper)


def registry_for_image(image: str) -> str:
    """The registry host of an image ref: explicit host (contains '.' or
    ':' or is 'localhost') else Docker Hub."""
    first = image.split("/", 1)[0]
    if "/" in image and ("." in first or ":" in first or first == "localhost"):
        return first
    return "docker.io"


def load_docker_config(path: Optional[str] = None) -> dict:
    p = Path(path or os.environ.get("DOCKER_CONFIG",
                                    "~/.docker")).expanduser()
    if p.is_dir():
        p = p / "config.json"
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def auth_for_registry(registry: str,
                      config: Optional[dict] = None) -> RegistryAuth:
    """auth.rs:43-84."""
    cfg = load_docker_config() if config is None else config
    out = RegistryAuth(registry=registry)

    helpers = cfg.get("credHelpers", {})
    if registry in helpers:
        out.cred_helper = helpers[registry]
        return out
    if cfg.get("credsStore"):
        out.cred_helper = cfg["credsStore"]

    auths = cfg.get("auths", {})
    keys = [registry]
    if registry in DOCKER_HUB_ALIASES or registry == "docker.io":
        keys = list(DOCKER_HUB_ALIASES)
    for key, entry in auths.items():
        norm = key.replace("https://", "").replace("http://", "").rstrip("/")
        if key in keys or norm == registry or norm.split("/")[0] == registry:
            if "auth" in entry:
                try:
                    user, _, pw = base64.b64decode(
                        entry["auth"]).decode().partition(":")
                    out.username, out.password = user, pw
                except Exception:
                    pass
            out.username = entry.get("username", out.username)
            out.password = entry.get("password", out.password)
            out.identity_token = entry.get("identitytoken")
            break
    return out
