#!/usr/bin/env python
"""Dependency-free self-lint of the port (the counterpart of the
reference's ``scripts/selflint.py``), over ``fleetflow_tpu_torch/`` only.

    python fleetflow_tpu_torch/tools/selflint.py

Checks (all conservative by construction — zero known false positives
beats exhaustiveness for a gate):

  syntax          every file compiles (ast.parse)
  undefined-name  a loaded name bound NOWHERE in the module (any scope),
                  not a builtin, and not imported — catches typos the way
                  ruff F821 does, under-approximating scoping on purpose
  unused-import   a module-level import whose root name is never read
                  anywhere in the file (skipped in __init__.py re-export
                  surfaces; honors __all__ strings and `# noqa` lines)
  FJ001+          the host-sync and async hygiene rules
                  (analysis/hygiene.py, stdlib-only) over solver/ and cp/
  FJ007+          the interprocedural dataflow rules
                  (analysis/dataflow.py, stdlib-only) over the whole
                  package

The FJ passes gate on ERROR-severity findings left after the port's
accepted-findings ledger (analysis/audit_baseline.json) is applied;
warnings print but don't gate. Imports nothing but the stdlib and the
port's own analysis package (no torch, no numpy).

Exit 0 clean, 1 findings (one per line: path:line: code message).
"""

from __future__ import annotations

import ast
import builtins
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

# names legitimately injected at runtime / by the harness
EXTRA_GLOBALS = {"__file__", "__name__", "__doc__", "__package__",
                 "__spec__", "__builtins__", "__debug__", "__path__",
                 "__version__", "__all__", "__annotations__", "WindowsError"}


def iter_py_files() -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git", "_ext_build")]
        out.extend(os.path.join(dirpath, f) for f in filenames
                   if f.endswith(".py"))
    return sorted(out)


class Binder(ast.NodeVisitor):
    """Collect every name BOUND anywhere in the module, any scope."""

    def __init__(self) -> None:
        self.bound: set[str] = set()

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.bound.add(node.id)

    def _bind_args(self, a: ast.arguments) -> None:
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            self.bound.add(arg.arg)
        if a.vararg:
            self.bound.add(a.vararg.arg)
        if a.kwarg:
            self.bound.add(a.kwarg.arg)

    def visit_FunctionDef(self, node) -> None:
        self.bound.add(node.name)
        self._bind_args(node.args)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._bind_args(node.args)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.bound.add(node.name)
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.bound.add((alias.asname or alias.name).split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            if alias.name != "*":
                self.bound.add(alias.asname or alias.name)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.name:
            self.bound.add(node.name)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self.bound.update(node.names)

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self.bound.update(node.names)


def has_star_import(tree: ast.Module) -> bool:
    return any(isinstance(n, ast.ImportFrom)
               and any(a.name == "*" for a in n.names)
               for n in ast.walk(tree))


def check_undefined(path: str, tree: ast.Module) -> list[str]:
    if has_star_import(tree):
        return []       # star imports make binding undecidable statically
    binder = Binder()
    binder.visit(tree)
    defined = binder.bound | set(dir(builtins)) | EXTRA_GLOBALS
    return [f"{path}:{node.lineno}: undefined-name {node.id!r} is never "
            f"bound in this module"
            for node in ast.walk(tree)
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
            and node.id not in defined]


def check_unused_imports(path: str, tree: ast.Module,
                         source: str) -> list[str]:
    if os.path.basename(path) == "__init__.py":
        return []       # re-export surface
    lines = source.splitlines()
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and not isinstance(node.ctx, ast.Store):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    # __all__ strings count as uses
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) \
                                and isinstance(el.value, str):
                            used.add(el.value)
    out = []
    for node in tree.body:      # module level only: local imports are
        names = []              # usually deliberate lazy loads
        if isinstance(node, ast.Import):
            names = [(a, (a.asname or a.name).split(".")[0])
                     for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__" \
                    or any(a.name == "*" for a in node.names):
                continue
            names = [(a, a.asname or a.name) for a in node.names]
        for alias, bound in names:
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if "noqa" in line or bound.startswith("_"):
                continue
            if bound not in used:
                out.append(f"{path}:{node.lineno}: unused-import "
                           f"{bound!r} is imported but never used")
    return out


def check_fj() -> tuple[list[str], int]:
    """The FJ passes (hygiene over solver/ and cp/, dataflow over the
    package) with the port's ledger applied. Returns (gating findings,
    warning count)."""
    sys.path.insert(0, REPO)
    try:
        from fleetflow_tpu_torch.analysis.baseline import (
            apply_baseline, default_baseline_path, load_baseline)
        from fleetflow_tpu_torch.analysis.dataflow import dataflow_lint_paths
        from fleetflow_tpu_torch.analysis.hygiene import hygiene_lint_paths
        from fleetflow_tpu_torch.lint.diagnostics import Severity
    except Exception as e:         # pragma: no cover - package broken
        return [f"fleetflow_tpu_torch/analysis: unavailable ({e})"], 0
    diags = hygiene_lint_paths([os.path.join(PKG, "solver"),
                                os.path.join(PKG, "cp")], rel_to=REPO)
    diags += dataflow_lint_paths([PKG], rel_to=REPO)
    try:
        diags, _, _ = apply_baseline(diags,
                                     load_baseline(default_baseline_path()))
    except (OSError, ValueError) as e:
        return [f"fleetflow_tpu_torch/analysis/audit_baseline.json: {e}"], 0
    gating = [d.format() for d in diags if d.severity is Severity.ERROR]
    warnings = 0
    for d in diags:
        if d.severity is not Severity.ERROR:
            warnings += 1
            print(d.format(), file=sys.stderr)
    return gating, warnings


def main() -> int:
    findings: list[str] = []
    files = iter_py_files()
    for path in files:
        rel = os.path.relpath(path, REPO)
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(f"{rel}:{e.lineno}: syntax {e.msg}")
            continue
        findings.extend(check_undefined(rel, tree))
        findings.extend(check_unused_imports(rel, tree, source))
    fj, fj_warnings = check_fj()
    findings.extend(fj)
    for f in findings:
        print(f)
    print(f"selflint: {len(findings)} finding(s) ({fj_warnings} FJ "
          f"warning(s)) over {len(files)} files", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
