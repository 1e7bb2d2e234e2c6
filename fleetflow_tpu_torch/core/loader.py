"""The config load pipeline.

Analog of crates/fleetflow-core/src/loader.rs: discover files, collect
variables in the reference's fixed priority chain, Tera/jinja-render every
file, concatenate in fixed order, include-expand, and parse into a Flow.

Variable priority (low → high, reference: loader.rs:77-134):

  1. builtin  PROJECT_ROOT (+ FLEET_PROJECT_ROOT, FLEET_STAGE)
  2. ``variables{}`` blocks in fleet.kdl (pre-pass over raw text)
  3. ``variables/*.kdl`` files (pre-pass)
  4. ``.env``
  5. ``.env.external``
  6. ``.env.{stage}``
  7. allowlisted process env (FLEET_* / CI_* / APP_*)
  8. stage-scoped ``variables{}`` blocks for the selected stage

``op://`` secret references are resolved as variables enter the context.

The port's copy of ``fleetflow_tpu/core/loader.py``.
"""

from __future__ import annotations

import os
from typing import Optional

from .discovery import DiscoveredFiles, discover_files_with_stage, find_project_root
from .errors import FlowError
from .model import Flow
from .parsecache import (M_FRONTEND_PHASE_MS, _env_int,
                         default_parse_cache)
from .parser import merge_flow_fragment, read_kdl_with_includes
from .template import TemplateProcessor, extract_variables_with_stage, parse_dotenv
from ..obs import get_logger, span

log = get_logger("loader")

__all__ = ["load_project", "load_project_from_root_with_stage",
           "prepare_template_processor", "expand_all_files",
           "render_file_parts", "LoadDebug"]


class LoadDebug:
    """Collects per-step artifacts for `fleet config --debug`
    (reference: loader.rs:214 debug loader)."""

    def __init__(self) -> None:
        self.files: list[str] = []
        self.variables: dict[str, str] = {}
        self.rendered: dict[str, str] = {}
        self.concatenated: str = ""
        # (start line in the concatenation, line count, source path, start
        # line in that file) — include-expansion-aware; the lint SourceMap
        # consumes this verbatim
        self.segments: list[tuple[int, int, str, int]] = []


def _read(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    except OSError as e:
        raise FlowError(f"cannot read {path}: {e}") from e


def prepare_template_processor(files: DiscoveredFiles,
                               stage: Optional[str] = None,
                               environ: Optional[dict[str, str]] = None,
                               resolve_secrets: bool = True) -> TemplateProcessor:
    """Build the variable context in the reference's priority order
    (loader.rs:77-134)."""
    environ = environ if environ is not None else dict(os.environ)
    tp = TemplateProcessor()

    # 1. builtins
    builtins = {"PROJECT_ROOT": files.root}
    if stage:
        builtins["FLEET_STAGE"] = stage
    tp.add_variables(builtins, resolve_secrets=False)

    # 2. variables{} in main + cloud files (raw-text pre-pass)
    for f in filter(None, (files.cloud_file, files.main_file)):
        tp.add_variables(extract_variables_with_stage(_read(f), None),
                         resolve_secrets=resolve_secrets)

    # 3. variables/*.kdl
    for f in files.variable_files:
        tp.add_variables(extract_variables_with_stage(_read(f), None),
                         resolve_secrets=resolve_secrets)

    # 4-6. dotenv chain
    for name in (".env", ".env.external") + ((f".env.{stage}",) if stage else ()):
        for base in (files.root, files.config_dir):
            p = os.path.join(base, name)
            if os.path.isfile(p):
                tp.add_variables(parse_dotenv(_read(p)),
                                 resolve_secrets=resolve_secrets)

    # 7. allowlisted env
    tp.add_allowlisted_env(environ)

    # 8. stage-scoped variables{} (highest)
    if stage:
        for f in filter(None, [files.main_file, *files.stage_files,
                               files.stage_override_file,
                               files.local_override_file]):
            all_with_stage = extract_variables_with_stage(_read(f), stage)
            top_only = extract_variables_with_stage(_read(f), None)
            stage_only = {k: v for k, v in all_with_stage.items()
                          if top_only.get(k) != v or k not in top_only}
            if stage_only:
                tp.add_variables(stage_only, resolve_secrets=resolve_secrets)
    return tp


def render_file_parts(files: DiscoveredFiles, tp: TemplateProcessor,
                      debug: Optional[LoadDebug] = None
                      ) -> list[tuple[str, str, int]]:
    """Render every discovered file in fixed order, returning
    ``(path, rendered text, 1-based start line in the concatenation)``
    per file. With a ``debug`` collector, per-file segments
    (include-expansion-aware) are recorded for the lint SourceMap; when
    template rendering changes a file's line count the fallback is
    whole-file granularity for that file."""
    parts: list[tuple[str, str, int]] = []
    cur_line = 1
    for path in files.all_files():
        inc_segs: list[tuple[int, int, str, int]] = []
        text = read_kdl_with_includes(path, segments=inc_segs)
        rendered = tp.render_str(text, source=path)
        n_rendered = rendered.count("\n") + 1
        if debug is not None:
            debug.files.append(path)
            debug.rendered[path] = rendered
            if n_rendered == text.count("\n") + 1:
                debug.segments.extend(
                    (cur_line + s - 1, n, p, ls) for s, n, p, ls in inc_segs)
            else:
                debug.segments.append((cur_line, n_rendered, path, 1))
        parts.append((path, rendered, cur_line))
        cur_line += n_rendered
    if debug is not None:
        debug.concatenated = "\n".join(r for _, r, _ in parts)
        debug.variables = dict(tp.variables)
    return parts


def expand_all_files(files: DiscoveredFiles, tp: TemplateProcessor,
                     debug: Optional[LoadDebug] = None) -> str:
    """Render every discovered file and concatenate in fixed order
    (reference: loader.rs:137-209). Kept for callers that want the full
    text; the load pipeline itself parses per-file fragments via
    :func:`render_file_parts` so the parse cache can reuse unchanged
    files."""
    return "\n".join(r for _, r, _ in render_file_parts(files, tp, debug))


def _parse_workers() -> int:
    """FLEET_PARSE_WORKERS: >1 parses independent files across a
    fork-based process pool (0/1 = serial, the default)."""
    return _env_int("FLEET_PARSE_WORKERS", 0)


def _fragment_job(args: tuple) -> "Flow":
    """Worker-side parse of one rendered file (module-level: must pickle).
    Consults the shared disk tier of the parse cache, so a pool and its
    parent never parse the same content twice across runs."""
    text, want_spans, offset = args
    from .parser import _parse_kdl_fragment
    pc = default_parse_cache()
    key = pc.key(text, want_spans, None, offset)
    frag = pc.get(key)
    if frag is None:
        frag = _parse_kdl_fragment(text, want_spans=want_spans,
                                   line_offset=offset)
        pc.put(key, frag)
    return frag


def _pool_init() -> None:   # keep workers from nesting their own pools
    os.environ["FLEET_PARSE_WORKERS"] = "0"


def _parse_parts(parts: list[tuple[str, str, int]],
                 want_spans: bool) -> list["Flow"]:
    """Rendered parts -> parsed fragments, in order. Cache lookups happen
    in-process; misses above the cache threshold optionally fan out to a
    FLEET_PARSE_WORKERS process pool (fork), each worker returning its
    fragment for the parent to merge and re-cache."""
    from .parser import _cache_min_bytes, _parse_kdl_fragment
    pc = default_parse_cache()
    min_bytes = _cache_min_bytes()
    frags: list = [None] * len(parts)
    todo: list[tuple[int, Optional[tuple], str, int]] = []
    for i, (_path, rendered, start) in enumerate(parts):
        off = start - 1
        key = (pc.key(rendered, want_spans, None, off)
               if len(rendered) >= min_bytes else None)
        frag = pc.get(key) if key is not None else None
        if frag is not None:
            frags[i] = frag
        else:
            todo.append((i, key, rendered, off))

    workers = _parse_workers()
    pooled = [t for t in todo if t[1] is not None]
    if workers > 1 and len(pooled) > 1:
        try:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            ctx = mp.get_context("fork")
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(pooled)), mp_context=ctx,
                    initializer=_pool_init) as ex:
                results = list(ex.map(
                    _fragment_job,
                    [(r, want_spans, o) for (_i, _k, r, o) in pooled]))
            for (i, key, _r, _o), frag in zip(pooled, results):
                frags[i] = frag
                pc.adopt(key, frag)   # workers own the disk tier write
            todo = [t for t in todo if t[1] is None]
        except FlowError:
            raise
        except Exception as e:  # fork unavailable / pool died: go serial
            log.debug("parallel parse unavailable (%s); parsing serially", e)

    for i, key, rendered, off in todo:
        if frags[i] is not None:
            continue
        frag = _parse_kdl_fragment(rendered, want_spans=want_spans,
                                   line_offset=off)
        frags[i] = frag
        if key is not None:
            pc.put(key, frag)
    return frags


def load_project_from_root_with_stage(root: str, stage: Optional[str] = None,
                                      environ: Optional[dict[str, str]] = None,
                                      resolve_secrets: bool = True,
                                      debug: Optional[LoadDebug] = None,
                                      want_spans: bool = False) -> Flow:
    """Full pipeline from a known project root (reference: loader.rs:42-74,
    `#[instrument]` on load_*: loader.rs:24-41).

    ``want_spans=True`` parses with the span-carrying KDL parser so model
    objects get source locations (`fleet lint`); pair it with a ``debug``
    collector to build a SourceMap from the rendered per-file segments.
    """
    import time

    with span(log, "load_project", root=root, stage=stage) as sp:
        files = discover_files_with_stage(root, stage)
        if files.main_file is None:
            raise FlowError(f"no {files.config_dir}/fleet.kdl")
        log.debug("discovered files=%d main=%s", len(files.all_files()),
                  files.main_file)
        tp = prepare_template_processor(files, stage, environ, resolve_secrets)
        log.debug("variable context: %d variables", len(tp.variables))
        parts = render_file_parts(files, tp, debug)
        # parse per-file fragments (content-addressed cache; optional
        # worker pool) and merge in the concatenation order — spans and
        # error positions keep concatenation coordinates via line_offset
        t0 = time.perf_counter()
        try:
            flow = Flow()
            for frag in _parse_parts(parts, want_spans):
                merge_flow_fragment(flow, frag)
        except FlowError:
            # compat guard: a construct SPANNING file boundaries (a brace
            # opened in one discovered file and closed in the next) parsed
            # under the historical whole-concatenation parse but fails as
            # a fragment. Re-parse the concatenation once; if that also
            # fails, its error carries the same coordinates the old path
            # reported — raise it.
            from .parser import parse_kdl_string
            flow = parse_kdl_string("\n".join(r for _, r, _ in parts),
                                    want_spans=want_spans, cache=False)
        M_FRONTEND_PHASE_MS.set((time.perf_counter() - t0) * 1e3,
                                phase="parse")
        # expose the final variable context on the flow
        merged = dict(tp.variables)
        merged.update(flow.variables)
        flow.variables = merged
        sp.update(project=flow.name, services=len(flow.services),
                  stages=len(flow.stages))
    return flow


def load_project(stage: Optional[str] = None, start: Optional[str] = None,
                 **kw) -> Flow:
    """Discover the project root from cwd and load (reference: loader.rs:25)."""
    return load_project_from_root_with_stage(find_project_root(start), stage, **kw)
