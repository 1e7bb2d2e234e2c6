"""Synchronous CP client + credential store.

Analog of fleetflow cp_client.rs:18-105 + auth.rs:68-263: connect to the
CP (pinned mesh-CA TLS when a CA cert is on disk), attach the stored
bearer token, and expose blocking `request` calls for CLI handlers. The
credential store is ~/.config/fleetflow/credentials.json (the reference
keeps Auth0 tokens there; ours holds CP-issued JWTs per endpoint).
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..cp.protocol import ProtocolClient, RpcError

__all__ = ["CredentialStore", "CpClient", "default_endpoint"]

CRED_PATH = "~/.config/fleetflow/credentials.json"
CA_PATH = "~/.local/state/fleetflow/ca/ca.pem"
DEFAULT_ENDPOINT = "127.0.0.1:4510"
ENDPOINT_ENV = "FLEET_CP_ENDPOINT"


def default_endpoint() -> str:
    return os.environ.get(ENDPOINT_ENV, DEFAULT_ENDPOINT)


@dataclass
class CredentialStore:
    path: str = CRED_PATH

    def _file(self) -> Path:
        return Path(os.path.expanduser(self.path))

    def _load(self) -> dict:
        try:
            return json.loads(self._file().read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def token_for(self, endpoint: str) -> Optional[str]:
        return self._load().get(endpoint, {}).get("token")

    def save_token(self, endpoint: str, token: str,
                   email: str = "") -> None:
        doc = self._load()
        doc[endpoint] = {"token": token, "email": email}
        f = self._file()
        f.parent.mkdir(parents=True, exist_ok=True)
        # create 0600 from the first byte — no world-readable window
        fd = os.open(f, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as fh:
            fh.write(json.dumps(doc, indent=2))

    def forget(self, endpoint: str) -> bool:
        doc = self._load()
        if endpoint not in doc:
            return False
        del doc[endpoint]
        self._file().write_text(json.dumps(doc, indent=2))
        return True


class CpClient:
    """Blocking facade over the asyncio protocol client; one event loop per
    CLI invocation."""

    def __init__(self, endpoint: Optional[str] = None, *,
                 token: Optional[str] = None,
                 ca_path: str = CA_PATH,
                 identity: str = "cli",
                 creds: Optional[CredentialStore] = None):
        self.endpoint = endpoint or default_endpoint()
        host, _, port = self.endpoint.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.creds = creds or CredentialStore()
        self.token = token or self.creds.token_for(self.endpoint)
        self.ca_path = os.path.expanduser(ca_path)
        self.identity = identity
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._conn = None
        self._task = None

    # ------------------------------------------------------------------
    def _ssl_context(self):
        """Returns (ctx, ca_source). FLEET_CP_CA overrides the ambient
        CA: a path pins that CA, an empty value / "none" forces plaintext
        (needed when a stale mesh CA from some earlier TLS daemon sits in
        ~/.local/state but the target CP is plaintext)."""
        override = os.environ.get("FLEET_CP_CA")
        if override is not None:
            if override.strip().lower() in ("", "none", "off"):
                return None, None
            from ..cp.cert import client_ssl_context
            path = os.path.expanduser(override)
            try:
                pem = Path(path).read_bytes()
            except OSError as e:
                raise RpcError(
                    f"cannot read FLEET_CP_CA={override!r}: {e}") from None
            return client_ssl_context(pem), path
        if os.path.isfile(self.ca_path):
            from ..cp.cert import client_ssl_context
            return client_ssl_context(Path(self.ca_path).read_bytes()), \
                self.ca_path
        return None, None

    def connect(self) -> "CpClient":
        import ssl as _ssl
        ctx, ca_source = self._ssl_context()   # before the loop: a bad CA
        self._loop = asyncio.new_event_loop()  # must not leak a fresh loop
        try:
            self._conn, self._task = self._loop.run_until_complete(
                ProtocolClient.connect(
                    self.host, self.port, identity=self.identity,
                    token=self.token, ssl_context=ctx))
        except _ssl.SSLError as e:
            self._loop.close()
            self._loop = None
            raise RpcError(
                f"TLS handshake with {self.endpoint} failed using the CA "
                f"at {ca_source}: {e.__class__.__name__}: {e}\n"
                "  if this CP runs plaintext (or a different CA), set "
                "FLEET_CP_CA= (empty) to disable pinning or point it at "
                "the right ca.pem") from None
        except (OSError, ConnectionError) as e:
            self._loop.close()
            self._loop = None
            detail = str(e) or repr(e)
            hint = ("  is fleetflowd running? (fleet cp daemon run)"
                    if ctx is None else
                    "  is fleetflowd running? (fleet cp daemon run)\n"
                    f"  note: connecting with TLS pinned to {ca_source}; "
                    "a plaintext CP drops TLS clients silently — set "
                    "FLEET_CP_CA= (empty) to disable pinning")
            raise RpcError(
                f"cannot reach control plane at {self.endpoint}: {detail}\n"
                f"{hint}") from None
        return self

    def request(self, channel: str, method: str,
                payload: Optional[dict] = None, timeout: float = 60.0) -> dict:
        if self._conn is None:
            self.connect()
        return self._loop.run_until_complete(
            self._conn.request(channel, method, payload, timeout=timeout))

    def close(self) -> None:
        if self._loop is not None and self._conn is not None:
            self._loop.run_until_complete(self._conn.close())
            if self._task:
                self._task.cancel()
            self._loop.close()
            self._loop = None
            self._conn = None

    def __enter__(self) -> "CpClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()
