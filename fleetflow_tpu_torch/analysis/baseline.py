"""Audit baseline (port of ``analysis/baseline.py``): the accepted-findings
ledger shared by hygiene + dataflow.

New rules must be able to land STRICT the day they're written, even when
the tree carries findings that are intentional (the port's deliberate host
syncs under its hot dispatches, such as the adaptive exit check every
``warm_block`` sweeps). The baseline is that ledger: a reviewed JSON file
of accepted findings, keyed ``rule + path + function`` with a count, so

  * an accepted finding stays accepted when its line number drifts
    (refactors move code; the function is the stable anchor),
  * a NEW finding in the same function still fails the gate the moment
    the count exceeds the accepted number,
  * deleting the code deletes the suppression on the next
    ``--update-baseline`` (stale entries are reported, not silently
    kept).

An entry may carry a ``why`` line (the reason the finding is accepted);
``--update-baseline`` keeps the ``why`` of every entry it writes again.
The port's ledger is ``fleetflow_tpu_torch/analysis/audit_baseline.json``
(its own paths; the reference's root ``audit_baseline.json`` is the
reference's).

Workflow::

    fleet --device cpu audit all --strict \
        --baseline fleetflow_tpu_torch/analysis/audit_baseline.json
    fleet audit dataflow --update-baseline

Stdlib-only, same contract as hygiene.py/dataflow.py: tools/selflint.py
runs this in dependency-free environments.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

from ..lint.diagnostics import Diagnostic

__all__ = ["Baseline", "load_baseline", "apply_baseline",
           "write_baseline", "default_baseline_path"]

_KEY = tuple  # (rule code, path, function)


@dataclass
class Baseline:
    """Accepted findings: (rule, path, function) -> accepted count."""
    entries: dict[tuple, int] = field(default_factory=dict)
    path: Optional[str] = None
    # (rule, path, function) -> why the finding is accepted
    why: dict[tuple, str] = field(default_factory=dict)

    @staticmethod
    def key(d: Diagnostic) -> tuple:
        return (d.code, d.file or "", d.function or "")

    def to_json(self) -> dict:
        return {
            "version": 1,
            "comment": "accepted audit findings, keyed rule+path+function"
                       " — regenerate with `fleet audit <pass>"
                       " --update-baseline`",
            "entries": [
                {"rule": r, "path": p, "function": f, "count": c,
                 **({"why": self.why[(r, p, f)]}
                    if (r, p, f) in self.why else {})}
                for (r, p, f), c in sorted(self.entries.items())],
        }


def default_baseline_path() -> str:
    """The port's ledger, beside this module in the package."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "audit_baseline.json")


def load_baseline(path: str) -> Baseline:
    """Parse a baseline file. Raises ValueError on malformed content —
    a baseline that silently loads empty would un-suppress everything
    and fail CI with noise, or worse, a typo'd key would suppress
    nothing while looking reviewed."""
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    if not isinstance(raw, dict) or not isinstance(raw.get("entries"),
                                                   list):
        raise ValueError(f"{path}: baseline must be an object with an "
                         f"'entries' list")
    b = Baseline(path=path)
    for i, e in enumerate(raw["entries"]):
        if not isinstance(e, dict) or "rule" not in e or "path" not in e:
            raise ValueError(f"{path}: entries[{i}] needs 'rule' and "
                             f"'path'")
        key = (str(e["rule"]), str(e["path"]), str(e.get("function", "")))
        b.entries[key] = b.entries.get(key, 0) + int(e.get("count", 1))
        if e.get("why"):
            b.why[key] = str(e["why"])
    return b


def apply_baseline(diags: list[Diagnostic], baseline: Baseline) \
        -> tuple[list[Diagnostic], int, list[tuple]]:
    """Split findings against the ledger.

    Returns ``(kept, suppressed_count, stale_keys)``: `kept` keeps its
    input order; per key, the first `count` findings are suppressed and
    any beyond it are kept (a new finding in an accepted function still
    fails). `stale_keys` are ledger entries that matched nothing — the
    code they excused is gone and the entry should be dropped."""
    budget = dict(baseline.entries)
    kept: list[Diagnostic] = []
    suppressed = 0
    for d in diags:
        k = Baseline.key(d)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            suppressed += 1
        else:
            kept.append(d)
    stale = sorted(k for k, c in budget.items()
                   if c == baseline.entries.get(k, 0) and c > 0)
    return kept, suppressed, stale


def write_baseline(diags: list[Diagnostic], path: str) -> Baseline:
    """Regenerate the ledger from the current findings (the
    ``--update-baseline`` path). Every write is a reviewed diff: the
    file is sorted and stable, so accepting one new finding shows as
    one hunk. The ``why`` of an entry the file at `path` already holds is
    kept."""
    b = Baseline(path=path)
    if os.path.exists(path):
        try:
            b.why = load_baseline(path).why
        except ValueError:
            pass
    for d in diags:
        k = Baseline.key(d)
        b.entries[k] = b.entries.get(k, 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(b.to_json(), fh, indent=2, sort_keys=False)
        fh.write("\n")
    return b
