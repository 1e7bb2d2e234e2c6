"""The port's image build subsystem (fleetflow_tpu_torch.build: the
resolver, the build context, registry auth and the docker drivers)
against the reference's, on the CPU.

- the build context: ``create_context`` of the same directory (a
  .dockerignore with globs, re-includes and directory prefixes, nested
  files, a symlink, an out-of-context Dockerfile) gives the same tar
  members, in the same order, with the same names, types, modes and
  contents as the reference's;
- the resolver's Dockerfile, context, merged build args and image tag, and
  its errors, equal the reference's; ``registry_for_image`` and
  ``auth_for_registry`` agree over a docker config with base64 and split
  credentials, Docker Hub aliases, a credential store and helpers;
- the builder and pusher run the same argv through an injected runner and
  raise the same errors;
- the reference's own build tests (tests/test_registry_build_cloud.py's
  TestBuild) on the port.
"""

from __future__ import annotations

import base64
import io
import tarfile

import pytest

from fleetflow_tpu.build import auth as ref_auth
from fleetflow_tpu.build import builder as ref_builder
from fleetflow_tpu.build import context as ref_context
from fleetflow_tpu.build import resolver as ref_resolver
from fleetflow_tpu.core import model as ref_model
from fleetflow_tpu_torch.build import (BuildResolver, ImageBuilder,
                                       ImagePusher, RegistryAuth,
                                       create_context, load_dockerignore,
                                       registry_for_image)
from fleetflow_tpu_torch.build.auth import auth_for_registry
from fleetflow_tpu_torch.build.builder import BuildFailed
from fleetflow_tpu_torch.build.context import is_ignored
from fleetflow_tpu_torch.build.resolver import BuildError, ResolvedBuild
from fleetflow_tpu_torch.core.model import BuildConfig, Service


def members(blob: bytes) -> list:
    """(name, type, mode, size, bytes) of every tar member, in order."""
    out = []
    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        for m in tar.getmembers():
            data = (tar.extractfile(m).read() if m.isfile() else
                    m.linkname.encode())
            out.append((m.name, m.type, m.mode, m.size, data))
    return out


@pytest.fixture
def context_dir(tmp_path):
    ctx = tmp_path / "ctx"
    (ctx / "src" / "pkg").mkdir(parents=True)
    (ctx / "node_modules" / "dep").mkdir(parents=True)
    (ctx / "logs").mkdir()
    (ctx / "Dockerfile").write_text("FROM scratch\nCOPY . /app\n")
    (ctx / "app.py").write_text("print(1)\n")
    (ctx / "src" / "pkg" / "mod.py").write_text("x = 1\n")
    (ctx / "src" / "pkg" / "notes.md").write_text("# notes\n")
    (ctx / "node_modules" / "dep" / "big.js").write_text("x" * 1000)
    (ctx / "logs" / "a.log").write_text("a")
    (ctx / "keep.log").write_text("keep")
    (ctx / "skip.log").write_text("skip")
    (ctx / "run.sh").write_text("#!/bin/sh\necho run\n")
    (ctx / "run.sh").chmod(0o755)
    (ctx / "link.py").symlink_to("app.py")
    (ctx / ".dockerignore").write_text(
        "# comment\nnode_modules/\n*.log\n!keep.log\nlogs\n"
        "src/**/*.md\n\n")
    outside = tmp_path / "Dockerfile.prod"
    outside.write_text("FROM scratch AS prod\n")
    return ctx, outside


def test_context_members_equal(context_dir):
    ctx, outside = context_dir
    for dockerfile in (None, ctx / "Dockerfile", outside):
        got = members(create_context(ctx, dockerfile))
        want = members(ref_context.create_context(ctx, dockerfile))
        assert got == want
    names = [m[0] for m in got]
    assert "keep.log" in names and "skip.log" not in names
    assert not any(n.startswith(("node_modules", "logs")) for n in names)
    assert names[-1] == "Dockerfile" and "src/pkg/mod.py" in names
    assert load_dockerignore(ctx) == ref_context.load_dockerignore(ctx)


@pytest.mark.parametrize("rel", [
    "a.log", "keep.log", "logs/x", "logsx", "node_modules", "src/a/b.md",
    "src/b.md", "Dockerfile", "deep/dir/file.log"])
def test_is_ignored_equal(rel):
    pats = ["node_modules", "*.log", "!keep.log", "logs", "src/**/*.md",
            "deep"]
    assert is_ignored(rel, pats) == ref_context.is_ignored(rel, pats)


def _ref_service(**kw):
    build = kw.pop("build", None)
    if build is not None:
        build = ref_model.BuildConfig(**build)
    return ref_model.Service(build=build, **kw)


def _port_service(**kw):
    build = kw.pop("build", None)
    if build is not None:
        build = BuildConfig(**build)
    return Service(build=build, **kw)


@pytest.mark.parametrize("case", [
    dict(name="app", image="app", version="2",
         build=dict(context="app", args={"A": "1"})),
    dict(name="app", image="ghcr.io/me/app", version="3",
         build=dict(context="app", dockerfile="app/Dockerfile",
                    target="prod", no_cache=True)),
    dict(name="app", image="app",
         build=dict(context="app", image_tag="localhost:5000/x:9")),
    dict(name="app", build=dict(context="nope")),
    dict(name="app", build=dict(context="app", dockerfile="missing")),
    dict(name="app"),
])
@pytest.mark.parametrize("registry", [None, "reg.example.com/"])
def test_resolver_equal(tmp_path, case, registry):
    (tmp_path / "app").mkdir()
    (tmp_path / "app" / "Dockerfile").write_text("FROM scratch\n")
    env = {"FLEET_BUILD_B": "2", "FLEET_BUILD_A": "env", "OTHER": "x"}

    def run(resolver, svc):
        try:
            r = resolver.resolve(svc)
        except Exception as e:     # noqa: BLE001 - compared, not swallowed
            return type(e).__name__, str(e)
        return (r.dockerfile, r.context, r.args, r.tag, r.target, r.no_cache)
    got = run(BuildResolver(str(tmp_path), registry=registry, env=env),
              _port_service(**dict(case)))
    want = run(ref_resolver.BuildResolver(str(tmp_path), registry=registry,
                                          env=env),
               _ref_service(**dict(case)))
    assert got == want


DOCKER_CONFIG = {
    "auths": {
        "ghcr.io": {"auth": base64.b64encode(b"me:tok").decode()},
        "https://index.docker.io/v1/": {"username": "hub",
                                        "password": "pw"},
        "registry.example.com/team": {"identitytoken": "idt"},
        "broken.io": {"auth": "!!!notbase64"},
    },
    "credHelpers": {"gcr.io": "gcloud"},
}


@pytest.mark.parametrize("registry", [
    "ghcr.io", "docker.io", "index.docker.io", "registry.example.com",
    "gcr.io", "broken.io", "other.io"])
@pytest.mark.parametrize("store", [None, "desktop"])
def test_auth_equal(registry, store):
    cfg = dict(DOCKER_CONFIG)
    if store:
        cfg["credsStore"] = store
    got = auth_for_registry(registry, cfg)
    want = ref_auth.auth_for_registry(registry, cfg)
    assert vars(got) == vars(want) and got.resolved == want.resolved


@pytest.mark.parametrize("image", [
    "redis:7", "library/redis", "ghcr.io/me/app:1", "localhost:5000/app",
    "localhost/app", "me/app", "a.b/c/d:e", "plain"])
def test_registry_for_image_equal(image):
    assert registry_for_image(image) == ref_auth.registry_for_image(image)


def test_load_docker_config_from_env(tmp_path, monkeypatch):
    from fleetflow_tpu_torch.build.auth import load_docker_config
    (tmp_path / "config.json").write_text(
        '{"auths": {"ghcr.io": {"username": "u"}}}')
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))
    assert load_docker_config() == ref_auth.load_docker_config() == {
        "auths": {"ghcr.io": {"username": "u"}}}
    (tmp_path / "config.json").write_text("{bad")
    assert load_docker_config() == {} == ref_auth.load_docker_config()


def test_builder_and_pusher_argv_equal(tmp_path, monkeypatch):
    (tmp_path / "config.json").write_text(
        '{"auths": {"ghcr.io": {"username": "u", "password": "p"}}}')
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))
    out = {}
    for pkg, B, R in (("ref", ref_builder, ref_resolver.ResolvedBuild),
                      ("port", __import__(
                          "fleetflow_tpu_torch.build.builder",
                          fromlist=["x"]), ResolvedBuild)):
        calls, lines = [], []

        def runner(args, on_line=None, calls=calls):
            calls.append(args)
            if on_line:
                on_line("step 1/1")
            return (1, "denied") if "bad/x:1" in args else (0, "ok")
        rb = R(dockerfile=tmp_path / "Dockerfile", context=tmp_path,
               args={"V": "9", "A": "1"}, tag="ghcr.io/me/app:1",
               target="prod", no_cache=True)
        tag = B.ImageBuilder(runner).build(rb, on_line=lines.append)
        pushed = B.ImagePusher(runner).push(tag, on_line=lines.append)
        errors = []
        for fn in (lambda: B.ImagePusher(runner).push("bad/x:1"),
                   lambda: B.ImagePusher(runner).push("quay.io/x:1"),
                   lambda: B.ImageBuilder(lambda a, o=None: (2, "boom"))
                   .build(rb)):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - compared
                errors.append((type(e).__name__, str(e)))
        out[pkg] = (tag, pushed, calls, lines, errors)
    assert out["port"] == out["ref"]


# --------------------------------------------------------------------------
# the reference's build tests on the port
# --------------------------------------------------------------------------

class TestBuild:
    def test_resolver(self, tmp_path):
        ctx = tmp_path / "app"
        ctx.mkdir()
        (ctx / "Dockerfile").write_text("FROM scratch\n")
        svc = Service(name="app", image="app", version="2",
                      build=BuildConfig(context="app", args={"A": "1"}))
        r = BuildResolver(str(tmp_path), registry="reg.example.com",
                          env={"FLEET_BUILD_B": "2", "OTHER": "x"})
        resolved = r.resolve(svc)
        assert resolved.dockerfile == ctx / "Dockerfile"
        assert resolved.context == ctx
        assert resolved.args == {"A": "1", "B": "2"}
        assert resolved.tag == "reg.example.com/app:2"

    def test_resolver_missing_context(self, tmp_path):
        svc = Service(name="x", build=BuildConfig(context="nope"))
        with pytest.raises(BuildError, match="context"):
            BuildResolver(str(tmp_path)).resolve(svc)

    def test_context_packing_with_dockerignore(self, tmp_path):
        ctx = tmp_path
        (ctx / "Dockerfile").write_text("FROM scratch")
        (ctx / "app.py").write_text("print(1)")
        (ctx / "node_modules").mkdir()
        (ctx / "node_modules" / "big.js").write_text("x" * 1000)
        (ctx / "keep.log").write_text("keep")
        (ctx / "skip.log").write_text("skip")
        (ctx / ".dockerignore").write_text(
            "node_modules\n*.log\n!keep.log\n")
        blob = create_context(ctx)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            names = sorted(tar.getnames())
        assert "Dockerfile" in names and "app.py" in names
        assert "keep.log" in names
        assert not any("node_modules" in n for n in names)
        assert "skip.log" not in names

    def test_builder_argv(self, tmp_path):
        calls = []

        def runner(args, on_line=None):
            calls.append(args)
            return 0, "ok"

        (tmp_path / "Dockerfile").write_text("FROM scratch")
        rb = ResolvedBuild(dockerfile=tmp_path / "Dockerfile",
                           context=tmp_path, args={"V": "9"},
                           tag="app:1", target="prod", no_cache=True)
        tag = ImageBuilder(runner).build(rb)
        assert tag == "app:1"
        argv = calls[0]
        assert argv[:2] == ["docker", "build"]
        assert "--build-arg" in argv and "V=9" in argv
        assert "--target" in argv and "--no-cache" in argv

    def test_registry_auth(self):
        assert registry_for_image("redis:7") == "docker.io"
        assert registry_for_image("ghcr.io/me/app:1") == "ghcr.io"
        assert registry_for_image("localhost:5000/app") == "localhost:5000"
        cfg = {"auths": {"ghcr.io": {
            "auth": base64.b64encode(b"me:tok").decode()}}}
        auth = auth_for_registry("ghcr.io", cfg)
        assert auth.username == "me" and auth.password == "tok"
        assert auth.resolved
        assert not auth_for_registry("other.io", cfg).resolved
        assert isinstance(auth, RegistryAuth)

    def test_push_without_credentials_fails(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))
        with pytest.raises(BuildFailed, match="docker login"):
            ImagePusher(lambda a, o=None: (0, "")).push("ghcr.io/me/a:1")

    def test_default_runner_streams_lines(self):
        from fleetflow_tpu_torch.build.builder import _default_runner
        lines = []
        rc, out = _default_runner(["sh", "-c", "echo one; echo two >&2"],
                                  lines.append)
        assert rc == 0 and lines == ["one", "two"] and out == "one\ntwo"
