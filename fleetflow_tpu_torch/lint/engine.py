"""Lint drivers: run the rule catalog over flows, projects, and raw text
(the port's copy of ``fleetflow_tpu/lint/engine.py``).

Three entry points, one per caller shape:

  lint_flow(flow, ...)       rules over an already-parsed Flow — the CLI,
                             tests, and anything holding a model
  lint_text(text, path)      one KDL document with exact spans — fixture
                             tests and single-file tooling
  lint_project(root, stage)  the full loader pipeline (discovery, template
                             render, includes) with a SourceMap resolving
                             concatenated lines back to their files — what
                             `fleet lint` runs

plus the deploy gate:

  deploy_blockers(flow, stage_name, local=...)  the structural error
      subset (and, for local single-node execution, the port/volume
      pigeonhole) — what DeployEngine.execute and the CP flow-submit
      handler consult BEFORE lowering, so a statically-doomed flow is
      rejected in milliseconds with coded diagnostics instead of minutes
      into a deploy. Inventory-dependent rules stay out: the CP solves
      against live inventory, not the flow's declared servers.

Load failures (template errors, KDL syntax, missing files) surface as
code FF000 — the "could not even parse" diagnostic — with the span the
underlying KdlError carried, when it carried one.
"""

from __future__ import annotations

import re
from typing import Optional

from ..core.errors import FlowError
from ..core.kdl import KdlError
from ..core.loader import LoadDebug, load_project_from_root_with_stage
from ..core.model import Flow
from ..core.parser import parse_kdl_string
from ..obs import get_logger
from .diagnostics import Diagnostic, Severity, SourceMap
from .rules import RULES, LintContext, Rule

__all__ = ["lint_flow", "lint_text", "lint_project", "deploy_blockers",
           "severity_counts", "LOAD_ERROR", "LintResult"]

log = get_logger("lint")

LOAD_ERROR = Rule(code="FF000", slug="load-error", severity=Severity.ERROR,
                  scope="flow", doc="config failed to load or parse",
                  fn=lambda: iter(()))

_SEVERITY_ORDER = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}


def _sorted(diags: list[Diagnostic]) -> list[Diagnostic]:
    return sorted(diags, key=lambda d: (_SEVERITY_ORDER[d.severity],
                                        d.file or "", d.line, d.col, d.code))


def severity_counts(diags: list[Diagnostic]) -> tuple[int, int]:
    """(errors, warnings) — INFO diagnostics are advisory and count as
    neither (they can never gate an exit code)."""
    errors = sum(1 for d in diags if d.severity is Severity.ERROR)
    warnings = sum(1 for d in diags if d.severity is Severity.WARNING)
    return errors, warnings


class LintResult:
    """Diagnostics plus the artifacts callers keep reaching for."""

    def __init__(self, diagnostics: list[Diagnostic],
                 flow: Optional[Flow] = None,
                 sourcemap: Optional[SourceMap] = None):
        self.diagnostics = diagnostics
        self.flow = flow
        self.sourcemap = sourcemap

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def infos(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.INFO]

    def ok(self, strict: bool = False) -> bool:
        # INFO never gates: it reports waste/tuning advice, not defects
        if strict:
            return not (self.errors or self.warnings)
        return not self.errors


def lint_flow(flow: Flow, sourcemap: Optional[SourceMap] = None, *,
              stage_name: Optional[str] = None, local: bool = False,
              prelint: bool = True,
              structural_only: bool = False) -> list[Diagnostic]:
    """Run the rule catalog over a parsed flow. ``stage_name`` restricts
    stage-scoped rules to one stage (the deploy gate); default is every
    stage. ``structural_only`` keeps to the inventory-independent subset."""
    ctx = LintContext(flow=flow, sourcemap=sourcemap, local=local,
                      prelint=prelint)
    if stage_name is not None:
        stages = [flow.stages[stage_name]] if stage_name in flow.stages else []
    else:
        stages = [flow.stages[k] for k in sorted(flow.stages)]
    out: list[Diagnostic] = []
    for r in RULES:
        if structural_only and not r.structural:
            continue
        if r.scope == "flow":
            if stage_name is None:      # flow rules once, not per deploy
                out.extend(r.fn(r, ctx))
            continue
        for stage in stages:
            if r.code == "FF013" and any(
                    d.severity is Severity.ERROR and d.stage == stage.name
                    for d in out):
                continue    # structural errors already doom the stage;
                            # prelint would only re-report them noisily
            out.extend(r.fn(r, ctx, stage))
    return _sorted(out)


_KDL_POS = re.compile(r"at (\d+):(\d+)")


def _load_error(e: Exception, file: Optional[str] = None) -> Diagnostic:
    line = col = 0
    cause = e
    while cause is not None:
        if isinstance(cause, KdlError):
            line, col = cause.line, cause.col
            break
        cause = cause.__cause__
    if not line:        # FlowError wrapping stringifies the position
        m = _KDL_POS.search(str(e))
        if m:
            line, col = int(m.group(1)), int(m.group(2))
    return Diagnostic(code=LOAD_ERROR.code, severity=Severity.ERROR,
                      message=str(e), file=file, line=line, col=col,
                      rule=LOAD_ERROR.slug)


def lint_text(text: str, path: str = "<string>", *,
              prelint: bool = True, local: bool = False) -> LintResult:
    """Lint one KDL document (no template pass): fixture tests, editors."""
    sm = SourceMap.single(path, text)
    try:
        flow = parse_kdl_string(text, want_spans=True)
    except (FlowError, ValueError) as e:
        # ValueError covers KdlError raised during the node->model walk
        # (e.g. strict-bool coercion), which parse_kdl_string only wraps
        # for the raw-document parse
        return LintResult([_load_error(e, path)], sourcemap=sm)
    return LintResult(lint_flow(flow, sm, prelint=prelint, local=local),
                      flow=flow, sourcemap=sm)


def lint_project(root: str, stage: Optional[str] = None, *,
                 environ: Optional[dict[str, str]] = None,
                 prelint: bool = True) -> LintResult:
    """Lint a project directory through the real loader pipeline.

    Secrets are NOT resolved (linting must not shell out to `op`; rule
    FF009 reports unresolvable references instead), and the rendered
    per-file segments become the SourceMap that turns concatenated-text
    spans back into file:line.
    """
    debug = LoadDebug()
    try:
        flow = load_project_from_root_with_stage(
            root, stage, environ=environ, resolve_secrets=False,
            debug=debug, want_spans=True)
    except (FlowError, ValueError) as e:
        # a template error names its file directly; use it when present
        m = re.search(r"template error in (\S+?):", str(e))
        return LintResult([_load_error(e, m.group(1) if m else None)],
                          sourcemap=SourceMap(segments=debug.segments))
    # the loader's segments are include-expansion-aware (a diagnostic
    # below an `include` still points at its true on-disk line)
    sm = SourceMap(segments=debug.segments)
    return LintResult(lint_flow(flow, sm, prelint=prelint),
                      flow=flow, sourcemap=sm)


def deploy_blockers(flow: Flow, stage_name: str, *,
                    local: bool = False) -> list[Diagnostic]:
    """The fail-fast gate: structural errors (plus, for local single-node
    execution, the port/volume pigeonhole — two containers genuinely
    cannot bind one host port on this machine). Cheap (O(services+edges),
    no numpy, no solver) because it runs on EVERY deploy and flow submit."""
    diags = lint_flow(flow, stage_name=stage_name, local=local,
                      prelint=False, structural_only=True)
    if local:
        ctx = LintContext(flow=flow, local=True, prelint=False)
        stage = flow.stages.get(stage_name)
        if stage is not None:
            ff006 = next(r for r in RULES if r.code == "FF006")
            diags = _sorted(diags + list(ff006.fn(ff006, ctx, stage)))
    return [d for d in diags if d.severity is Severity.ERROR]
