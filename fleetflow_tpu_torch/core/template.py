"""Template expansion over KDL text.

Analog of crates/fleetflow-core/src/template.rs (Tera-based in the reference;
jinja2 here — same `{{ var }}` / `{% if %}` surface). Provides:

  - :class:`TemplateProcessor` with a layered variable context
  - env-var allowlist: only ``FLEET_*`` / ``CI_*`` / ``APP_*`` enter the
    template context (reference: template.rs:70)
  - ``.env`` file parsing (reference: template.rs:114)
  - a *pre-pass* that extracts ``variables{}`` blocks (including stage-scoped
    ones) from raw KDL text before rendering (reference: template.rs:227,239)
  - 1Password ``op://vault/item/field`` reference resolution inside variables
    (reference: template.rs:42-51, onepassword.rs) — gated on the ``op``
    binary being present
  - an ``env(name=..., default=...)`` template function (template.rs:105)

Note: shell-style ``${VAR:-default}`` strings inside service env values are
NOT template syntax — they pass through verbatim for container-runtime
expansion, exactly as in the reference.

The port's copy of ``fleetflow_tpu/core/template.py``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import jinja2

from .errors import FlowError
from .secrets import is_op_reference, resolve_op_references

__all__ = ["TemplateProcessor", "parse_dotenv", "extract_variables_with_stage",
           "ENV_ALLOWLIST_PREFIXES"]

ENV_ALLOWLIST_PREFIXES = ("FLEET_", "CI_", "APP_")


def parse_dotenv(text: str) -> dict[str, str]:
    """Parse `.env` content: KEY=VALUE lines, optional `export `, quotes
    stripped, `#` comments (reference: template.rs:114)."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export "):]
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        else:
            # strip trailing inline comment on unquoted values
            hash_pos = value.find(" #")
            if hash_pos >= 0:
                value = value[:hash_pos].rstrip()
        if key:
            out[key] = value
    return out


_VARIABLES_RE = re.compile(r"^\s*variables\s*\{", re.MULTILINE)
_STAGE_RE = re.compile(r'^\s*stage\s+"(?P<name>[^"]+)"\s*\{', re.MULTILINE)


def _match_block(text: str, open_brace: int) -> int:
    """Index just past the `}` matching the `{` at open_brace. Brace counting
    skips string literals and // comments, since this runs on *unrendered*
    text that the KDL parser may not accept yet."""
    depth = 0
    i = open_brace
    n = len(text)
    while i < n:
        c = text[i]
        if c == '"':
            i += 1
            while i < n and text[i] != '"':
                i += 2 if text[i] == "\\" else 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    raise FlowError("unbalanced braces while scanning variables block")


_VAR_LINE_RE = re.compile(r'^\s*(?P<key>[A-Za-z_][A-Za-z0-9_.-]*)\s+(?P<val>.+?)\s*$')


def _parse_variables_body(body: str) -> dict[str, str]:
    """Parse a variables{} block body. Tries real KDL first (handles values
    containing '//', escapes, etc. — the reference parses the block as KDL
    too); falls back to lenient line-wise parsing for bodies that contain
    unrendered template syntax KDL can't digest."""
    from .kdl import parse_document
    try:
        nodes = parse_document(body)
        out: dict[str, str] = {}
        for n in nodes:
            v = n.arg(0, "")
            out[n.name] = "" if v is None else \
                ("true" if v is True else "false" if v is False else str(v))
        return out
    except Exception:
        pass
    out = {}
    for line in body.splitlines():
        stripped = line.strip()
        if stripped.startswith("//") or not stripped or stripped in "{}":
            continue
        m = _VAR_LINE_RE.match(stripped)
        if not m:
            continue
        val = m.group("val").strip()
        if len(val) >= 2 and val[0] == '"' and val[-1] == '"':
            val = val[1:-1]
        out[m.group("key")] = val
    return out


def extract_variables_with_stage(text: str, stage: Optional[str] = None) -> dict[str, str]:
    """Pre-pass: pull variable definitions out of raw (unrendered) KDL text.

    Collects top-level ``variables{}`` blocks, then — when ``stage`` is given —
    overlays ``variables{}`` blocks found inside that ``stage "name" { ... }``
    (reference: template.rs:227,239). Runs before template rendering, so it
    tolerates template syntax elsewhere in the file.
    """
    out: dict[str, str] = {}

    # Stage spans, so we can tell top-level variables from stage-scoped ones.
    stage_spans: list[tuple[int, int, str]] = []
    for m in _STAGE_RE.finditer(text):
        open_brace = text.index("{", m.start())
        try:
            end = _match_block(text, open_brace)
        except FlowError:
            continue
        stage_spans.append((m.start(), end, m.group("name")))

    def enclosing_stage(pos: int) -> Optional[str]:
        for s, e, name in stage_spans:
            if s <= pos < e:
                return name
        return None

    stage_vars: dict[str, str] = {}
    for m in _VARIABLES_RE.finditer(text):
        open_brace = text.index("{", m.start())
        try:
            end = _match_block(text, open_brace)
        except FlowError:
            continue
        body = text[open_brace + 1 : end - 1]
        owner = enclosing_stage(m.start())
        parsed = _parse_variables_body(body)
        if owner is None:
            out.update(parsed)
        elif stage is not None and owner == stage:
            stage_vars.update(parsed)
    out.update(stage_vars)  # stage-scoped wins
    return out


def _tera_compatible_default(_input, default=None, **kwargs):
    """Accept both jinja (`default("x")`) and Tera (`default(value="x")`)."""
    if default is None and "value" in kwargs:
        default = kwargs["value"]
    if isinstance(_input, jinja2.Undefined) or _input is None or _input == "":
        return default
    return _input


class TemplateProcessor:
    """Layered variable context + jinja2 rendering (reference: template.rs:19)."""

    def __init__(self, strict: bool = True):
        self.variables: dict[str, str] = {}
        self._env = jinja2.Environment(
            undefined=jinja2.StrictUndefined if strict else jinja2.Undefined,
            keep_trailing_newline=True,
        )
        self._env.filters["default"] = _tera_compatible_default

        def env_fn(name: str = "", default: Optional[str] = None) -> str:
            v = os.environ.get(name)
            if v is None:
                if default is None:
                    raise FlowError(f"env() called for unset variable {name!r} with no default")
                return default
            return v

        self._env.globals["env"] = env_fn

    # -- context layering ---------------------------------------------------

    def add_variables(self, vars: dict[str, str], resolve_secrets: bool = True) -> None:
        """Add a variable layer (later layers win). ``op://`` references are
        resolved here, matching the reference's resolve-inside-variables flow
        (template.rs:42-51)."""
        if resolve_secrets and any(is_op_reference(v) for v in vars.values()):
            vars = resolve_op_references(vars)
        self.variables.update({k: str(v) for k, v in vars.items()})

    def add_allowlisted_env(self, environ: Optional[dict[str, str]] = None) -> None:
        """Only FLEET_* / CI_* / APP_* env vars enter the context
        (reference: template.rs:70)."""
        environ = environ if environ is not None else dict(os.environ)
        for k, v in environ.items():
            if k.startswith(ENV_ALLOWLIST_PREFIXES):
                self.variables[k] = v

    # -- rendering ----------------------------------------------------------

    def render_str(self, template: str, source: str = "<string>") -> str:
        try:
            return self._env.from_string(template).render(**self.variables)
        except jinja2.UndefinedError as e:
            raise FlowError(
                f"template error in {source}: {e}; "
                f"known variables: {sorted(self.variables)[:20]}") from e
        except jinja2.TemplateError as e:
            raise FlowError(f"template error in {source}: {e}") from e

    def render_file(self, path: str) -> str:
        try:
            with open(path, "r", encoding="utf-8") as f:
                content = f.read()
        except OSError as e:
            raise FlowError(f"cannot read {path}: {e}") from e
        return self.render_str(content, source=path)

    def render_files(self, paths: list[str]) -> str:
        """Render every file and concatenate (reference: template.rs:198)."""
        return "\n".join(self.render_file(p) for p in paths)
