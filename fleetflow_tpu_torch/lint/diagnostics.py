"""Diagnostic records for fleet-config static analysis (the port's copy
of ``fleetflow_tpu/lint/diagnostics.py``).

Compiler-style diagnostics over parsed flows: every doomed-deploy class
gets a stable code (``FF0xx``), a severity, a human message, and — when
the config came from real files — a resolved ``file:line:col`` span.
The code is the contract: tests pin codes, CI greps them, and docs
catalog them (docs/guide/09-lint.md), so codes are never renumbered.

Spans travel in two steps: the KDL parser records node line/col in the
*parsed text* (core/kdl.py), and a :class:`SourceMap` maps a line of the
loader's rendered multi-file concatenation back to the file it came from
(the classic ``#line``-directive trick, built from the loader's per-file
rendered segments).
"""

from __future__ import annotations

import enum
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Optional

from ..core.model import SourceLoc

__all__ = ["Severity", "Diagnostic", "SourceMap"]


class Severity(str, enum.Enum):
    ERROR = "error"      # the deploy WILL fail; `fleet up`/CP submit reject
    WARNING = "warning"  # suspicious but deployable; --strict promotes
    INFO = "info"        # advisory (perf/waste); never fails, even --strict


@dataclass
class Diagnostic:
    """One finding: code + severity + message + (resolved) source span."""

    code: str                      # stable "FF0xx"
    severity: Severity
    message: str
    file: Optional[str] = None     # resolved through the SourceMap
    line: int = 0                  # 1-based; 0 = no span available
    col: int = 0
    rule: str = ""                 # rule slug, e.g. "dependency-cycle"
    stage: Optional[str] = None    # stage the finding applies to, if any
    hint: str = ""                 # optional fix suggestion
    function: str = ""             # enclosing function (audit baseline key)

    def span(self) -> str:
        f = self.file or "<config>"
        return f"{f}:{self.line}:{self.col}" if self.line else f

    def format(self) -> str:
        """``file:line:col: error FF001: message`` (the gcc/rustc shape
        editors and CI annotations already know how to parse)."""
        out = f"{self.span()}: {self.severity.value} {self.code}: {self.message}"
        if self.stage:
            out += f" [stage {self.stage}]"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity.value,
             "message": self.message, "rule": self.rule}
        if self.file:
            d["file"] = self.file
        if self.line:
            d["line"] = self.line
            d["col"] = self.col
        if self.stage:
            d["stage"] = self.stage
        if self.hint:
            d["hint"] = self.hint
        if self.function:
            d["function"] = self.function
        return d


@dataclass
class SourceMap:
    """Line map from the loader's rendered concatenation back to files.

    ``segments`` is ordered: ``(first line of the segment in the
    concatenated text, line count, file path, 1-based first line of the
    segment IN that file)``. The fourth element makes include expansion
    exact: the run of an including file *after* an ``include`` line keeps
    its true on-disk start, and the included file's lines map to the
    included file (segments from core/parser.py read_kdl_with_includes,
    threaded through core/loader.py expand_all_files). Line numbers refer
    to the *rendered* file — identical to the source wherever template
    expansion is line-preserving (the common case: ``{{ var }}``
    substitution never adds or removes lines; expand_all_files falls back
    to whole-file granularity when a template changes the line count).
    """

    segments: list[tuple[int, int, str, int]] = field(default_factory=list)

    @classmethod
    def from_parts(cls, files: list[str], parts: list[str]) -> "SourceMap":
        segs: list[tuple[int, int, str, int]] = []
        cur = 1
        for path, text in zip(files, parts):
            nlines = text.count("\n") + 1
            segs.append((cur, nlines, path, 1))
            cur += nlines   # "\n".join: next part starts on a fresh line
        return cls(segments=segs)

    @classmethod
    def single(cls, path: str, text: str) -> "SourceMap":
        return cls.from_parts([path], [text])

    def resolve(self, line: int) -> tuple[Optional[str], int]:
        """Concatenated 1-based line → (file, file-local 1-based line).
        (None, line) when the line precedes every segment or no map."""
        if not self.segments or line <= 0:
            return None, line
        starts = [s[0] for s in self.segments]
        i = bisect_right(starts, line) - 1
        if i < 0:
            return None, line
        start, _n, path, local_start = self.segments[i]
        return path, line - start + local_start

    def locate(self, loc: Optional[SourceLoc]) -> tuple[Optional[str], int, int]:
        """SourceLoc → (file, line, col); a loc carrying its own file wins
        (single-file parses label locs directly)."""
        if loc is None or not loc.line:
            return None, 0, 0
        if loc.file is not None:
            return loc.file, loc.line, loc.col
        f, ln = self.resolve(loc.line)
        return f, ln, loc.col
