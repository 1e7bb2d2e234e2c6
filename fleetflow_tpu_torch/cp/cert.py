"""Mesh CA: private certificate authority for control-plane TLS (the
port's copy of ``fleetflow_tpu/cp/cert.py``; the CA's common name is the
reference's, so either package's clients pin either package's CA).

Analog of controlplane cert.rs (MeshCa from club-unison): generate and
persist a private CA (key file 0600), issue a per-boot server certificate
with SANs, and hand agents/CLI the CA public cert for pinning
(TrustAnchors::Custom in the reference; `ssl.SSLContext.load_verify_locations`
here). Client code trusts ONLY this CA — never the system roots — which is
the pinning property the reference relies on (cp_client.rs:105).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from pathlib import Path
from typing import Optional

import ssl

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

__all__ = ["MeshCa", "ensure_mesh_ca", "server_ssl_context",
           "client_ssl_context"]

CA_CN = "fleetflow-tpu mesh ca"
_ONE_DAY = datetime.timedelta(days=1)


class MeshCa:
    def __init__(self, key, cert: x509.Certificate):
        self.key = key
        self.cert = cert

    # -- persistence --------------------------------------------------------
    @classmethod
    def generate(cls) -> "MeshCa":
        key = ec.generate_private_key(ec.SECP256R1())
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, CA_CN)])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - _ONE_DAY)
                .not_valid_after(now + datetime.timedelta(days=3650))
                .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                               critical=True)
                .sign(key, hashes.SHA256()))
        return cls(key, cert)

    def save(self, dir_path: str) -> None:
        d = Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        key_pem = self.key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        key_file = d / "ca.key"
        key_file.write_bytes(key_pem)
        os.chmod(key_file, 0o600)           # cert.rs: key file 0600
        (d / "ca.pem").write_bytes(
            self.cert.public_bytes(serialization.Encoding.PEM))

    @classmethod
    def load(cls, dir_path: str) -> Optional["MeshCa"]:
        d = Path(dir_path)
        key_file, cert_file = d / "ca.key", d / "ca.pem"
        if not (key_file.exists() and cert_file.exists()):
            return None
        key = serialization.load_pem_private_key(key_file.read_bytes(), None)
        cert = x509.load_pem_x509_certificate(cert_file.read_bytes())
        return cls(key, cert)

    @property
    def ca_pem(self) -> bytes:
        return self.cert.public_bytes(serialization.Encoding.PEM)

    # -- issuance -----------------------------------------------------------
    def issue_server_cert(self, common_name: str,
                          sans: list[str]) -> tuple[bytes, bytes]:
        """Per-boot server cert with SANs (cert.rs issue_server_cert).
        Returns (key_pem, cert_pem)."""
        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        alt_names: list[x509.GeneralName] = []
        for san in sans:
            try:
                alt_names.append(x509.IPAddress(ipaddress.ip_address(san)))
            except ValueError:
                alt_names.append(x509.DNSName(san))
        cert = (x509.CertificateBuilder()
                .subject_name(x509.Name([
                    x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
                .issuer_name(self.cert.subject)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - _ONE_DAY)
                .not_valid_after(now + datetime.timedelta(days=90))
                .add_extension(x509.SubjectAlternativeName(alt_names),
                               critical=False)
                .sign(self.key, hashes.SHA256()))
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        cert_pem = cert.public_bytes(serialization.Encoding.PEM)
        return key_pem, cert_pem


def ensure_mesh_ca(dir_path: str) -> MeshCa:
    """Load-or-generate (cert.rs ensure_mesh_ca:36)."""
    ca = MeshCa.load(dir_path)
    if ca is None:
        ca = MeshCa.generate()
        ca.save(dir_path)
    return ca


def server_ssl_context(ca: MeshCa, common_name: str = "cp",
                       sans: Optional[list[str]] = None,
                       work_dir: Optional[str] = None) -> ssl.SSLContext:
    """TLS context for the CP listener with a freshly issued cert."""
    import tempfile
    key_pem, cert_pem = ca.issue_server_cert(
        common_name, sans or ["localhost", "127.0.0.1", "::1"])
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    d = Path(work_dir) if work_dir else Path(tempfile.mkdtemp(prefix="ffcp-"))
    d.mkdir(parents=True, exist_ok=True)
    key_f, cert_f = d / "server.key", d / "server.pem"
    key_f.write_bytes(key_pem)
    os.chmod(key_f, 0o600)
    cert_f.write_bytes(cert_pem)
    ctx.load_cert_chain(str(cert_f), str(key_f))
    return ctx


def client_ssl_context(ca_pem: bytes) -> ssl.SSLContext:
    """Client context pinned to the mesh CA only (cp_client.rs:105)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cadata=ca_pem.decode())
    ctx.check_hostname = False          # identity = CA pinning, like the ref
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
