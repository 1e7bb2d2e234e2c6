"""Auth providers (the port's copy of ``fleetflow_tpu/cp/auth.py``).

Analog of controlplane auth.rs:17-38: an enum-dispatched provider — NoAuth
for local/dev, TokenAuth (self-issued HS256 with a shared secret, the CP as
its own identity provider), and JwksAuth: RS256 verification against a
cached JWKS document, the reference's production path (auth.rs:26-38
Auth0Verifier: JWKS cache + semaphore, Claims with permissions). Claims
carry email + permissions like the reference's; a token is obtained either
by minting (shared secret) or via the OAuth Device Flow against the
external IdP (the CLI's device flow, not ported yet).

HS256 JWT is implemented inline (HMAC-SHA256 + base64url): no external
deps, and the token format stays interoperable with standard tooling — a
token either package mints verifies in the other. RS256 verification uses
the `cryptography` package, imported only when a JwksAuth installs or
checks a key: plaintext servers with token auth need no `cryptography`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union

from ..core.errors import ControlPlaneError

__all__ = ["AuthError", "Claims", "NoAuth", "TokenAuth", "JwksAuth",
           "make_provider"]


class AuthError(ControlPlaneError):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


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


class TokenAuth:
    """HS256 JWT issue + verify with a shared secret."""

    def __init__(self, secret: str):
        if not secret:
            raise AuthError("TokenAuth requires a non-empty secret")
        self._key = secret.encode()

    def issue(self, email: str, permissions: list[str],
              tenant: str = "default", ttl_s: float = 86400.0) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        now = time.time()
        payload = {"sub": email, "email": email, "permissions": permissions,
                   "tenant": tenant, "iat": int(now), "exp": int(now + ttl_s)}
        signing = (_b64url(json.dumps(header, separators=(",", ":")).encode())
                   + "." +
                   _b64url(json.dumps(payload, separators=(",", ":")).encode()))
        sig = hmac.new(self._key, signing.encode(), hashlib.sha256).digest()
        return signing + "." + _b64url(sig)

    def verify(self, token: Optional[str]) -> Claims:
        if not token:
            raise AuthError("missing token")
        try:
            signing, _, sig_part = token.rpartition(".")
            header_part, _, payload_part = signing.partition(".")
            header = json.loads(_unb64url(header_part))
            if header.get("alg") != "HS256":
                raise AuthError(f"unsupported alg {header.get('alg')!r}")
            expected = hmac.new(self._key, signing.encode(),
                                hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _unb64url(sig_part)):
                raise AuthError("bad signature")
            payload = json.loads(_unb64url(payload_part))
        except AuthError:
            raise
        except Exception as e:
            raise AuthError(f"malformed token: {e}") from None
        exp = float(payload.get("exp", 0))
        if exp and exp < time.time():
            raise AuthError("token expired")
        return Claims(sub=str(payload.get("sub", "")),
                      email=str(payload.get("email", "")),
                      permissions=list(payload.get("permissions", [])),
                      tenant=str(payload.get("tenant", "default")),
                      exp=exp)


def _on_event_loop() -> bool:
    """True when the calling thread is running an asyncio event loop (the
    CP handshake / web authorize paths) — blocking there is forbidden."""
    import asyncio
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


class JwksAuth:
    """RS256 verification against a cached JWKS (auth.rs:26-38).

    `source` is a JWKS document location: an http(s) URL (the reference's
    `https://{domain}/.well-known/jwks.json`), a local file path (tests,
    air-gapped deploys), or an already-parsed dict. Keys are cached by
    `kid`; an unknown kid triggers ONE refetch (rate-limited to one per
    `refresh_cooldown_s`, the analog of the reference's semaphore-guarded
    JWKS cache) so key rotation works without restarting the CP.

    Verification enforces: RS256 alg, known kid, RSA-PKCS1v15-SHA256
    signature, `exp`, and — when configured — `iss` and `aud`. Permissions
    come from the `permissions` claim (Auth0 RBAC) with fallback to the
    space-separated `scope` claim. The CP cannot ISSUE tokens under this
    provider; issue() raises (the IdP owns identity)."""

    def __init__(self, source: Union[str, dict], issuer: Optional[str] = None,
                 audience: Optional[str] = None,
                 refresh_cooldown_s: float = 300.0):
        # signing keys fetched over cleartext can be swapped by
        # an on-path attacker, forging every identity the CP accepts.
        # Plain http is allowed only for loopback (the mock-IdP test rig).
        if isinstance(source, str) and source.startswith("http://"):
            host = urllib.parse.urlsplit(source).hostname or ""
            if host not in ("127.0.0.1", "localhost", "::1"):
                raise AuthError(
                    f"refusing cleartext JWKS source {source!r}: use https "
                    "or a local file path (http is allowed for loopback only)")
        self._source = source
        self._issuer = issuer
        self._audience = audience
        self._cooldown = refresh_cooldown_s
        self._keys: dict[str, object] = {}
        self._last_fetch = 0.0
        self._lock = threading.Lock()
        if isinstance(source, dict):
            self._install(source)
        else:
            self._refresh(force=True)

    # -- JWKS handling ----------------------------------------------------
    def _install(self, doc: dict) -> None:
        from cryptography.hazmat.primitives.asymmetric.rsa import (
            RSAPublicNumbers)
        keys = {}
        for k in doc.get("keys", []):
            if k.get("kty") != "RSA" or not k.get("kid"):
                continue
            try:
                n = int.from_bytes(_unb64url(k["n"]), "big")
                e = int.from_bytes(_unb64url(k["e"]), "big")
                keys[k["kid"]] = RSAPublicNumbers(e, n).public_key()
            except (KeyError, ValueError):
                continue
        self._keys = keys

    def _fetch(self) -> dict:
        src = self._source
        if isinstance(src, str) and src.startswith(("http://", "https://")):
            with urllib.request.urlopen(src, timeout=10) as resp:
                return json.loads(resp.read())
        if isinstance(src, str):
            return json.loads(Path(src).read_text())
        return src

    def _refresh(self, force: bool = False) -> Optional[threading.Thread]:
        """Refresh the key cache. Local/dict sources refresh inline (a
        disk read). An http(s) source refreshes in a BACKGROUND thread:
        verify() runs on the CP's event loop (protocol handshake, web
        _authorize), and a synchronous 10 s fetch there would stall every
        heartbeat and RPC in the process. The spawned thread is returned
        so the unknown-kid path can grant it a short bounded join: a fast
        fetch completes in-request and the rotated token verifies
        immediately; a slow fetch keeps the no-stall property and
        the client retries against the updated cache. `force` (constructor)
        fetches inline regardless: it runs before the server serves
        traffic and must fail loudly."""
        is_http = (isinstance(self._source, str)
                   and self._source.startswith(("http://", "https://")))
        with self._lock:
            now = time.monotonic()
            if not force and now - self._last_fetch < self._cooldown:
                return None
            self._last_fetch = now
        if force or not is_http:
            try:
                doc = self._fetch()
            except Exception as e:
                if force:
                    raise AuthError(
                        f"cannot load JWKS from {self._source!r}: {e}") \
                        from None
                return None  # rotation refetch failed: keep cached keys
            with self._lock:
                self._install(doc)
            return None

        def bg():
            try:
                doc = self._fetch()
            except Exception:
                return   # keep serving cached keys
            with self._lock:
                self._install(doc)

        t = threading.Thread(target=bg, name="jwks-refresh", daemon=True)
        t.start()
        return t

    # -- provider API -----------------------------------------------------
    def issue(self, email: str, permissions: list[str],
              tenant: str = "default", ttl_s: float = 86400.0) -> str:
        raise AuthError("JwksAuth cannot issue tokens; the external IdP "
                        "owns identity (use its device flow to log in)")

    def verify(self, token: Optional[str]) -> Claims:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        if not token:
            raise AuthError("missing token")
        try:
            signing, _, sig_part = token.rpartition(".")
            header_part, _, payload_part = signing.partition(".")
            header = json.loads(_unb64url(header_part))
            sig = _unb64url(sig_part)
        except Exception as e:
            raise AuthError(f"malformed token: {e}") from None
        if header.get("alg") != "RS256":
            raise AuthError(f"unsupported alg {header.get('alg')!r}")
        kid = header.get("kid", "")
        key = self._keys.get(kid)
        if key is None:
            # key rotation: one cooldown-limited hit; give a background
            # http fetch up to 1.5s to land so the first post-rotation
            # verify usually succeeds in-request — but NEVER
            # block the CP's event loop (a bogus-kid token is pre-auth
            # input, and the no-stall property is the whole point of the
            # background fetch): join only from plain threads.
            fetcher = self._refresh()
            if fetcher is not None and not _on_event_loop():
                fetcher.join(timeout=1.5)
            key = self._keys.get(kid)
        if key is None:
            raise AuthError(f"unknown signing key {kid!r}")
        try:
            key.verify(sig, signing.encode(), padding.PKCS1v15(),
                       hashes.SHA256())
        except InvalidSignature:
            raise AuthError("bad signature") from None
        try:
            payload = json.loads(_unb64url(payload_part))
        except Exception as e:
            raise AuthError(f"malformed payload: {e}") from None
        exp = float(payload.get("exp", 0))
        if not exp:
            # external tokens without expiry are irrevocable short of a
            # key rotation; a strict verifier refuses them
            raise AuthError("token missing exp")
        if exp < time.time():
            raise AuthError("token expired")
        if self._issuer and payload.get("iss") != self._issuer:
            raise AuthError(f"wrong issuer {payload.get('iss')!r}")
        if self._audience:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self._audience not in auds:
                raise AuthError(f"wrong audience {aud!r}")
        perms = list(payload.get("permissions", []))
        if not perms and payload.get("scope"):
            perms = str(payload["scope"]).split()
        return Claims(sub=str(payload.get("sub", "")),
                      email=str(payload.get("email", payload.get("sub", ""))),
                      permissions=perms,
                      tenant=str(payload.get("tenant", "default")),
                      exp=exp)


def make_provider(kind: str, secret: Optional[str] = None,
                  jwks: Optional[Union[str, dict]] = None,
                  issuer: Optional[str] = None,
                  audience: Optional[str] = None):
    """auth.rs AuthProviderKind enum dispatch."""
    if kind in ("none", "noauth", ""):
        return NoAuth()
    if kind in ("token", "jwt"):
        return TokenAuth(secret or "")
    if kind in ("jwks", "auth0", "oidc"):
        if not jwks:
            raise AuthError(f"{kind!r} auth requires a JWKS url/path")
        return JwksAuth(jwks, issuer=issuer, audience=audience)
    raise AuthError(f"unknown auth provider {kind!r}")
