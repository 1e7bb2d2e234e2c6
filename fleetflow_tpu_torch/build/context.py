"""Build-context packing.

Analog of fleetflow-build context.rs:13: pack the context directory into a
tar.gz honoring `.dockerignore` (glob patterns, `!` re-includes, directory
prefixes), the archive the engine's build API consumes.

The port's copy of ``fleetflow_tpu/build/context.py``.
"""

from __future__ import annotations

import fnmatch
import io
import tarfile
from pathlib import Path

__all__ = ["load_dockerignore", "create_context", "is_ignored"]


def load_dockerignore(context: Path) -> list[str]:
    f = context / ".dockerignore"
    if not f.is_file():
        return []
    patterns = []
    for line in f.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            patterns.append(line.rstrip("/"))
    return patterns


def is_ignored(rel: str, patterns: list[str]) -> bool:
    """Last match wins; `!pattern` re-includes (dockerignore semantics)."""
    ignored = False
    for pat in patterns:
        negate = pat.startswith("!")
        if negate:
            pat = pat[1:]
        hit = (fnmatch.fnmatch(rel, pat)
               or fnmatch.fnmatch(rel, pat + "/*")
               or rel == pat
               or rel.startswith(pat + "/"))
        if hit:
            ignored = not negate
    return ignored


def create_context(context: Path, dockerfile: Path | None = None) -> bytes:
    """context.rs create_context:13 — tar.gz bytes of the context with
    .dockerignore applied; an out-of-context dockerfile is injected as
    `Dockerfile` at the archive root (docker's remote-dockerfile behavior)."""
    patterns = load_dockerignore(context)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for path in sorted(context.rglob("*")):
            rel = path.relative_to(context).as_posix()
            if is_ignored(rel, patterns):
                continue
            if path.is_file() or path.is_symlink():
                tar.add(path, arcname=rel, recursive=False)
        if dockerfile is not None:
            try:
                dockerfile.relative_to(context)
            except ValueError:
                tar.add(dockerfile, arcname="Dockerfile", recursive=False)
    return buf.getvalue()
