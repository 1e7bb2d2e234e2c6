"""OAuth 2.0 Device Authorization Grant login (RFC 8628).

Analog of the reference CLI's Auth0 Device Flow
(crates/fleetflow/src/auth.rs:68-263): request a device code, show the
user the verification URI + user code, poll the token endpoint until the
user approves in a browser, then hand the access token to the credential
store. Works against any RFC 8628 IdP (Auth0 shape: `/oauth/device/code`
and `/oauth/token` under the issuer base URL).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

__all__ = ["DeviceFlowError", "device_login"]


class DeviceFlowError(Exception):
    pass


def _post_form(url: str, fields: dict, timeout: float = 15.0) -> dict:
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # OAuth error responses ride 4xx with a JSON body (RFC 8628 §3.5)
        try:
            return json.loads(e.read())
        except Exception:
            raise DeviceFlowError(f"IdP returned HTTP {e.code}") from None
    except (urllib.error.URLError, TimeoutError) as e:
        raise DeviceFlowError(f"cannot reach IdP: {e}") from None


def device_login(idp_url: str, client_id: str,
                 audience: Optional[str] = None, scope: str = "",
                 *, out: Callable[[str], None] = print,
                 sleep: Callable[[float], None] = time.sleep,
                 timeout_s: float = 300.0) -> dict:
    """Run the device flow; returns the token response dict (at least
    `access_token`). Raises DeviceFlowError on denial or timeout.

    auth.rs:68 request_device_code -> :233 poll_for_token mapping; `out`
    and `sleep` are injectable for tests (and so a TUI can re-skin the
    prompt without re-implementing the protocol).
    """
    base = idp_url.rstrip("/")
    fields = {"client_id": client_id}
    if audience:
        fields["audience"] = audience
    if scope:
        fields["scope"] = scope
    dc = _post_form(f"{base}/oauth/device/code", fields)
    if "device_code" not in dc:
        raise DeviceFlowError(
            f"device code request failed: {dc.get('error', dc)}")

    uri = dc.get("verification_uri_complete") or dc.get("verification_uri", "")
    out(f"To log in, visit: {uri}")
    if dc.get("user_code"):
        out(f"and enter code: {dc['user_code']}")

    interval = float(dc.get("interval", 5))
    deadline = time.monotonic() + min(timeout_s,
                                      float(dc.get("expires_in", timeout_s)))
    while time.monotonic() < deadline:
        sleep(interval)
        tok = _post_form(f"{base}/oauth/token", {
            "grant_type": "urn:ietf:params:oauth:grant-type:device_code",
            "device_code": dc["device_code"],
            "client_id": client_id,
        })
        if "access_token" in tok:
            return tok
        err = tok.get("error", "")
        if err == "authorization_pending":
            continue
        if err == "slow_down":
            interval += 5   # RFC 8628 §3.5: back off by 5 s
            continue
        if err in ("access_denied", "expired_token"):
            raise DeviceFlowError(f"login {err.replace('_', ' ')}")
        raise DeviceFlowError(f"token poll failed: {err or tok}")
    raise DeviceFlowError("login timed out waiting for approval")
