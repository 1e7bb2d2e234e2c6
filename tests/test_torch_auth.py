"""The port's auth providers (fleetflow_tpu_torch.cp.auth) against the
reference's, on the CPU.

- tests/test_cp.py's TestAuth and tests/test_auth_idp.py's TestJwksAuth,
  TestClaimsWildcards, TestChannelPermissions, TestJwksEndToEnd and
  TestJwksTransportHygiene (and the RPC half of its
  TestCrossSurfaceVocabulary) on both packages;
- tokens across packages: an HS256 token minted by either package's
  TokenAuth verifies in the other's to equal claims, and the same RS256
  token verifies in both packages' JwksAuth to equal claims;
- `make_provider`'s dispatch.

The tests of test_auth_idp.py that go through ``daemon.web.WebServer`` or
``cli`` (TestWebRoutePermissions, the REST half of
TestCrossSurfaceVocabulary, TestBrowserDeviceLogin; TestDeviceFlow) are in
tests/test_torch_daemon.py and tests/test_torch_cli.py.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from torch_wire_kit import HOSTS, PORT, REF, connect, ids, run, start_cp

pytest.importorskip("cryptography")


@pytest.fixture(params=HOSTS, ids=ids(HOSTS))
def P(request):
    return request.param


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class RsaIdp:
    """One RSA key, its JWKS document, RS256 token minting."""

    def __init__(self, kid: str = "k1", issuer: str = "https://idp.test/"):
        from cryptography.hazmat.primitives.asymmetric import rsa
        self.key = rsa.generate_private_key(public_exponent=65537,
                                            key_size=2048)
        self.kid = kid
        self.issuer = issuer

    def jwks(self) -> dict:
        pub = self.key.public_key().public_numbers()
        nbytes = (pub.n.bit_length() + 7) // 8
        return {"keys": [{
            "kty": "RSA", "kid": self.kid, "use": "sig", "alg": "RS256",
            "n": _b64url(pub.n.to_bytes(nbytes, "big")),
            "e": _b64url(pub.e.to_bytes(3, "big"))}]}

    def token(self, sub: str = "auth0|user1", permissions=None, scope=None,
              exp_in: float = 3600.0, aud="fleet-api", kid=None,
              issuer=None, email="op@example.com") -> str:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        header = {"alg": "RS256", "typ": "JWT", "kid": kid or self.kid}
        payload = {"sub": sub, "email": email,
                   "iss": issuer or self.issuer, "aud": aud,
                   "iat": int(time.time()),
                   "exp": int(time.time() + exp_in)}
        if permissions is not None:
            payload["permissions"] = permissions
        if scope is not None:
            payload["scope"] = scope
        signing = (_b64url(json.dumps(header).encode()) + "." +
                   _b64url(json.dumps(payload).encode()))
        sig = self.key.sign(signing.encode(), padding.PKCS1v15(),
                            hashes.SHA256())
        return signing + "." + _b64url(sig)


@pytest.fixture(scope="module")
def idp():
    return RsaIdp()


class TestTokenAuth:
    def test_token_roundtrip_and_tamper(self, P):
        A = P.auth
        auth = A.TokenAuth("secret")
        token = auth.issue("a@b.c", ["deploy:write"], tenant="acme")
        claims = auth.verify(token)
        assert claims.email == "a@b.c" and claims.tenant == "acme"
        assert claims.has("deploy:write") and not claims.has("admin:all")
        for bad in (token[:-4] + "AAAA", "not.a.token"):
            with pytest.raises(A.AuthError):
                auth.verify(bad)
        with pytest.raises(A.AuthError):
            A.TokenAuth("other").verify(token)
        with pytest.raises(A.AuthError, match="missing token"):
            auth.verify(None)

    def test_expiry(self, P):
        auth = P.auth.TokenAuth("secret")
        with pytest.raises(P.auth.AuthError, match="expired"):
            auth.verify(auth.issue("a@b.c", [], ttl_s=-10))

    def test_noauth(self, P):
        assert P.auth.NoAuth().verify(None).has("anything")
        assert P.auth.NoAuth().issue("a@b.c", []) == ""

    def test_empty_secret_refused(self, P):
        with pytest.raises(P.auth.AuthError, match="non-empty secret"):
            P.auth.TokenAuth("")

    @pytest.mark.parametrize("minter,checker", [(REF, PORT), (PORT, REF)],
                             ids=["ref-mints", "port-mints"])
    def test_tokens_cross_packages(self, minter, checker):
        tok = minter.auth.TokenAuth("shared").issue(
            "op@x", ["read:*", "write:deploy"], tenant="acme", ttl_s=600)
        got = checker.auth.TokenAuth("shared").verify(tok)
        want = minter.auth.TokenAuth("shared").verify(tok)
        assert asdict(got) == asdict(want)
        with pytest.raises(checker.auth.AuthError, match="bad signature"):
            checker.auth.TokenAuth("other").verify(tok)

    def test_same_token_bytes(self, monkeypatch):
        """With one clock, both packages mint the same token."""
        import fleetflow_tpu.cp.auth as ref_auth
        import fleetflow_tpu_torch.cp.auth as port_auth
        for mod in (ref_auth, port_auth):
            monkeypatch.setattr(mod.time, "time", lambda: 1_790_000_000.0)
        assert ref_auth.TokenAuth("k").issue("a@b", ["x"]) == \
            port_auth.TokenAuth("k").issue("a@b", ["x"])
        assert port_auth._b64url(b"\xff\x00") == ref_auth._b64url(b"\xff\x00")
        assert port_auth._unb64url("_wA") == b"\xff\x00"


class TestJwksAuth:
    def test_valid_token_verifies(self, P, idp):
        auth = P.auth.JwksAuth(idp.jwks(), issuer=idp.issuer,
                               audience="fleet-api")
        claims = auth.verify(idp.token(permissions=["read:servers"]))
        assert claims.email == "op@example.com"
        assert claims.has("read:servers") and not claims.has("write:servers")

    def test_scope_fallback(self, P, idp):
        claims = P.auth.JwksAuth(idp.jwks()).verify(
            idp.token(scope="read:stages write:stages"))
        assert claims.has("read:stages") and claims.has("write:stages")

    @pytest.mark.parametrize("kw,match", [
        (dict(exp_in=-10), "expired"),
        (dict(issuer="https://evil.test/"), "issuer"),
        (dict(aud="other-api"), "audience"),
        (dict(kid="rotated-away"), "unknown signing key")],
        ids=["expired", "issuer", "audience", "kid"])
    def test_rejected(self, P, idp, kw, match):
        auth = P.auth.JwksAuth(idp.jwks(), issuer=idp.issuer,
                               audience="fleet-api")
        with pytest.raises(P.auth.AuthError, match=match):
            auth.verify(idp.token(**kw))

    def test_tampered_signature_rejected(self, P, idp):
        head, pay, sig = idp.token().split(".")
        with pytest.raises(P.auth.AuthError, match="signature"):
            P.auth.JwksAuth(idp.jwks()).verify(f"{head}.{pay}.{sig[:-4]}AAAA")

    def test_hs256_alg_confusion_rejected(self, P, idp):
        hs = P.auth.TokenAuth("guessable").issue("evil@x", ["admin:all"])
        with pytest.raises(P.auth.AuthError, match="alg"):
            P.auth.JwksAuth(idp.jwks()).verify(hs)

    def test_missing_exp_rejected(self, P, idp):
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        signing = (_b64url(json.dumps({"alg": "RS256",
                                       "kid": idp.kid}).encode()) + "." +
                   _b64url(json.dumps({"sub": "s"}).encode()))
        sig = idp.key.sign(signing.encode(), padding.PKCS1v15(),
                           hashes.SHA256())
        with pytest.raises(P.auth.AuthError, match="missing exp"):
            P.auth.JwksAuth(idp.jwks()).verify(signing + "." + _b64url(sig))

    def test_key_rotation_refetches(self, P, idp, tmp_path):
        path = tmp_path / "jwks.json"
        path.write_text(json.dumps(idp.jwks()))
        auth = P.auth.JwksAuth(str(path))
        auth._cooldown = 0.0
        assert auth.verify(idp.token()).sub
        idp2 = RsaIdp(kid="k2", issuer=idp.issuer)
        doc = idp.jwks()
        doc["keys"] += idp2.jwks()["keys"]
        path.write_text(json.dumps(doc))
        assert auth.verify(idp2.token()).sub

    def test_jwks_file_source_and_make_provider(self, P, idp, tmp_path):
        path = tmp_path / "jwks.json"
        path.write_text(json.dumps(idp.jwks()))
        auth = P.auth.make_provider("auth0", jwks=str(path),
                                    issuer=idp.issuer)
        assert auth.verify(idp.token()).email == "op@example.com"
        with pytest.raises(P.auth.AuthError, match="issue"):
            auth.issue("x@y", ["admin:all"])

    def test_bad_source_fails_loudly(self, P, tmp_path):
        with pytest.raises(P.auth.AuthError, match="cannot load JWKS"):
            P.auth.JwksAuth(str(tmp_path / "missing.json"))

    def test_same_claims_in_both_packages(self, idp):
        tok = idp.token(permissions=["read:health"], email="x@y")
        got = [asdict(P.auth.JwksAuth(idp.jwks(), issuer=idp.issuer,
                                      audience="fleet-api").verify(tok))
               for P in HOSTS]
        assert got[0] == got[1]


class TestClaimsWildcards:
    def test_verb_wildcard(self, P):
        c = P.auth.Claims(sub="s", permissions=["read:*"])
        assert c.has("read:anything") and not c.has("write:anything")

    def test_admin_all(self, P):
        assert P.auth.Claims(sub="s", permissions=["admin:all"]).has("write:x")


class TestMakeProvider:
    def test_dispatch(self, P, idp):
        A = P.auth
        assert isinstance(A.make_provider("none"), A.NoAuth)
        assert isinstance(A.make_provider(""), A.NoAuth)
        assert isinstance(A.make_provider("jwt", "s"), A.TokenAuth)
        assert isinstance(A.make_provider("oidc", jwks=idp.jwks()),
                          A.JwksAuth)
        with pytest.raises(A.AuthError, match="requires a JWKS"):
            A.make_provider("jwks")
        with pytest.raises(A.AuthError, match="unknown auth provider"):
            A.make_provider("kerberos")


class TestChannelPermissions:
    def test_read_only_client_cannot_mutate(self, P):
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            ro = handle.state.auth.issue("ro@x", ["read:*"])
            conn, task = await connect(P, handle, token=ro)
            assert "tenants" in await conn.request("tenant", "list")
            with pytest.raises(P.protocol.RpcError, match="write:tenant"):
                await conn.request("tenant", "create", {"name": "acme"})
            # decrypted secret material is not a read-grant payload
            with pytest.raises(P.protocol.RpcError, match="write:tenant"):
                await conn.request("tenant", "secret.get",
                                   {"name": "t", "key": "k"})
            await conn.close()
            task.cancel()
            await handle.stop()
        run(go())

    def test_admin_token_can_mutate(self, P):
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            admin = handle.state.auth.issue("op@x", ["admin:all"])
            conn, task = await connect(P, handle, token=admin)
            out = await conn.request("tenant", "create", {"name": "acme"})
            await conn.close()
            task.cancel()
            await handle.stop()
            return out
        assert run(go())["tenant"]["name"] == "acme"

    def test_same_grant_on_the_rpc_surface(self, P):
        async def go():
            handle = await start_cp(P, auth_kind="token", auth_secret="s3")
            tok = handle.state.auth.issue("s@x", ["read:server"])
            conn, task = await connect(P, handle, token=tok)
            out = await conn.request("server", "list")
            with pytest.raises(P.protocol.RpcError, match="read:tenant"):
                await conn.request("tenant", "list")
            await conn.close()
            task.cancel()
            await handle.stop()
            return out
        assert "servers" in run(go())

    def test_token_from_the_other_package_opens_the_server(self):
        """A client holding a token the reference minted reaches the
        port's server with that token's grants, and the reverse."""
        async def go(server, minter):
            handle = await start_cp(server, auth_kind="token",
                                    auth_secret="s3")
            tok = minter.auth.TokenAuth("s3").issue("ro@x", ["read:*"])
            conn, task = await connect(server, handle, token=tok)
            ok = await conn.request("tenant", "list")
            with pytest.raises(server.protocol.RpcError,
                               match="write:tenant"):
                await conn.request("tenant", "create", {"name": "x"})
            await conn.close()
            task.cancel()
            await handle.stop()
            return ok
        assert run(go(PORT, REF)) == run(go(REF, PORT)) == {"tenants": []}


class TestJwksEndToEnd:
    def test_rs256_token_against_cp(self, P, idp, tmp_path):
        path = tmp_path / "jwks.json"
        path.write_text(json.dumps(idp.jwks()))

        async def go():
            handle = await start_cp(P, auth_kind="jwks",
                                    auth_jwks=str(path),
                                    auth_issuer=idp.issuer,
                                    auth_client_id="dash")
            assert handle.state.auth_idp == {
                "issuer": idp.issuer, "client_id": "dash",
                "audience": None}
            tok = idp.token(permissions=["read:health", "read:tenant"])
            conn, task = await connect(P, handle, token=tok)
            assert (await conn.request("health", "ping"))["pong"]
            with pytest.raises(P.protocol.RpcError, match="write:tenant"):
                await conn.request("tenant", "create", {"name": "x"})
            await conn.close()
            task.cancel()
            with pytest.raises(Exception):
                await connect(P, handle, token="not-a-jwt")
            await handle.stop()
        run(go())


class TestJwksTransportHygiene:
    def test_cleartext_jwks_rejected(self, P):
        with pytest.raises(P.auth.AuthError, match="cleartext"):
            P.auth.JwksAuth("http://idp.example.com/.well-known/jwks.json")

    def test_loopback_http_and_rotation_join(self, P, idp):
        doc = {"doc": json.dumps(idp.jwks())}

        class JwksHandler(BaseHTTPRequestHandler):
            def do_GET(self):
                body = doc["doc"].encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass
        srv = HTTPServer(("127.0.0.1", 0), JwksHandler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            auth = P.auth.JwksAuth(
                f"http://127.0.0.1:{srv.server_port}/jwks.json")
            auth._cooldown = 0.0
            assert auth.verify(idp.token()).sub
            idp2 = RsaIdp(kid="k-rot", issuer=idp.issuer)
            merged = idp.jwks()
            merged["keys"] += idp2.jwks()["keys"]
            doc["doc"] = json.dumps(merged)
            assert auth.verify(idp2.token()).sub == "auth0|user1"
        finally:
            srv.shutdown()

    def test_no_join_on_the_event_loop(self, P, idp, monkeypatch):
        """An unknown kid seen on the CP's loop starts the background
        fetch but never joins it there."""
        auth = P.auth.JwksAuth(idp.jwks())
        joined = []

        class Thread:
            def join(self, timeout=None):
                joined.append(timeout)
        monkeypatch.setattr(auth, "_refresh", lambda force=False: Thread())

        async def on_loop():
            assert P.auth._on_event_loop()
            with pytest.raises(P.auth.AuthError, match="unknown signing"):
                auth.verify(idp.token(kid="new"))
        run(on_loop())
        assert joined == [] and not P.auth._on_event_loop()
        with pytest.raises(P.auth.AuthError, match="unknown signing"):
            auth.verify(idp.token(kid="new"))
        assert joined == [1.5]
