"""Static analysis of fleet configs (`fleet lint`; the port's copy of
``fleetflow_tpu/lint``).

Span-carrying, coded diagnostics (FF0xx) over parsed flows: every class
of statically-doomed deployment — dependency cycles, dangling references,
pigeonholed host ports, unsatisfiable resource asks, trivially infeasible
placements — is caught at parse time with a file:line span instead of
minutes into lowering, annealing, or wave execution.

See docs/guide/09-lint.md for the rule catalog and exit-code contract.
"""

from .diagnostics import Diagnostic, Severity, SourceMap
from .engine import (LOAD_ERROR, LintResult, deploy_blockers, lint_flow,
                     lint_project, lint_text, severity_counts)
from .rules import RULES, LintContext, Rule

__all__ = [
    "Diagnostic", "Severity", "SourceMap",
    "Rule", "RULES", "LintContext",
    "LintResult", "lint_flow", "lint_text", "lint_project",
    "deploy_blockers", "severity_counts", "LOAD_ERROR",
]
