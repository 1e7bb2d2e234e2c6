"""Tenant secret encryption at rest (the port's copy of
``fleetflow_tpu/cp/crypto.py``).

Analog of controlplane crypto.rs:1-16: AES-256-GCM, wire format
base64(nonce ‖ ciphertext ‖ tag), master key from the
FLEETFLOW_MASTER_KEY env var as 64 hex chars. Uses the `cryptography`
package's AESGCM (the tag is appended to the ciphertext by the primitive,
matching the reference's layout).
"""

from __future__ import annotations

import base64
import os
import secrets as _secrets

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from ..core.errors import ControlPlaneError

__all__ = ["SecretBox", "master_key_from_env", "generate_master_key"]

ENV_KEY = "FLEETFLOW_MASTER_KEY"
NONCE_LEN = 12


class CryptoError(ControlPlaneError):
    pass


def generate_master_key() -> str:
    return _secrets.token_hex(32)


def master_key_from_env() -> bytes:
    hexkey = os.environ.get(ENV_KEY, "")
    if len(hexkey) != 64:
        raise CryptoError(
            f"{ENV_KEY} must be 64 hex chars (32 bytes); got {len(hexkey)}")
    try:
        return bytes.fromhex(hexkey)
    except ValueError:
        raise CryptoError(f"{ENV_KEY} is not valid hex") from None


class SecretBox:
    def __init__(self, key: bytes):
        if len(key) != 32:
            raise CryptoError("AES-256-GCM key must be 32 bytes")
        self._aead = AESGCM(key)

    @classmethod
    def from_env(cls) -> "SecretBox":
        return cls(master_key_from_env())

    def encrypt(self, plaintext: str, aad: str = "") -> str:
        nonce = _secrets.token_bytes(NONCE_LEN)
        ct = self._aead.encrypt(nonce, plaintext.encode(),
                                aad.encode() or None)
        return base64.b64encode(nonce + ct).decode()

    def decrypt(self, token: str, aad: str = "") -> str:
        try:
            blob = base64.b64decode(token)
            nonce, ct = blob[:NONCE_LEN], blob[NONCE_LEN:]
            return self._aead.decrypt(nonce, ct, aad.encode() or None).decode()
        except Exception as e:
            raise CryptoError(f"decryption failed: {type(e).__name__}") from None
