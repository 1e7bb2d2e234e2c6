"""SARIF 2.1.0 rendering for lint/audit diagnostics (the port's copy of
``fleetflow_tpu/lint/sarif.py``).

SARIF is the interchange format CI annotation surfaces (GitHub code
scanning, Azure DevOps, VS Code SARIF viewer) already speak: one run per
tool, one `result` per diagnostic, rules cataloged once with their docs.
`fleet lint --format sarif` and `fleet audit hygiene --format sarif` emit
it so a failing CI step shows up as inline PR annotations on the exact
file:line:col span instead of a log to scroll.

Severity mapping follows the SARIF spec's three levels: ERROR -> error,
WARNING -> warning, INFO -> note (INFO never gates the exit code, same
contract as the text/json formats).
"""

from __future__ import annotations

from typing import Optional

from .diagnostics import Diagnostic, Severity

__all__ = ["to_sarif"]

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
           "Schemata/sarif-schema-2.1.0.json")

_LEVEL = {Severity.ERROR: "error", Severity.WARNING: "warning",
          Severity.INFO: "note"}


def _rule_entry(d: Diagnostic) -> dict:
    entry: dict = {"id": d.code}
    if d.rule:
        entry["name"] = d.rule
        entry["shortDescription"] = {"text": d.rule.replace("-", " ")}
    return entry


def _result(d: Diagnostic) -> dict:
    message = d.message
    if d.hint:
        message += f" (hint: {d.hint})"
    res: dict = {
        "ruleId": d.code,
        "level": _LEVEL[d.severity],
        "message": {"text": message},
    }
    loc: dict = {"physicalLocation": {
        "artifactLocation": {"uri": d.file or "<config>"}}}
    if d.line:
        loc["physicalLocation"]["region"] = {
            "startLine": d.line,
            "startColumn": max(d.col, 1),
        }
    res["locations"] = [loc]
    if d.stage:
        res["properties"] = {"stage": d.stage}
    return res


def to_sarif(diagnostics: list[Diagnostic], *,
             tool: str = "fleet-lint",
             version: Optional[str] = None) -> dict:
    """One SARIF document for a diagnostic list. Rules are cataloged in
    first-appearance order; results keep the caller's ordering (already
    severity-sorted by the engine)."""
    rules: dict[str, dict] = {}
    for d in diagnostics:
        rules.setdefault(d.code, _rule_entry(d))
    driver: dict = {
        "name": tool,
        "informationUri":
            "https://github.com/chronista-club/fleetflow",
        "rules": list(rules.values()),
    }
    if version:
        driver["version"] = version
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": driver},
            "results": [_result(d) for d in diagnostics],
        }],
    }
