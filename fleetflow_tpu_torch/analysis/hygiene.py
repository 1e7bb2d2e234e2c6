"""FJ001+ — host-sync and async hygiene rules over Python source, AST only
(port of ``analysis/hygiene.py``).

The lint/ package proves fleet *configs* can't deploy doomed; this module
holds the *codebase* to the equivalent bar for the two failure classes
that threaten the perf contracts:

  host sync in a hot     a ``.item()``, a ``float()`` on a tensor, an
  dispatch               ``np.`` call, or an env read inside a hot dispatch
                         round-trips the host (or reads config) on every
                         call, exactly what the warm path's no-upload
                         checks exist to forbid
  async CP hazards       a blocking call inside an ``async def`` handler
                         stalls the whole CP event loop; an ``await`` while
                         holding the (threading) store lock parks the
                         lock across a scheduling point and deadlocks the
                         sync writers sharing it

PyTorch traces nothing, so the reference's "traced code" (a ``jax.jit``
root and what is nested in it) becomes a HOT DISPATCH and what is nested
in it. A function is a hot dispatch when it is

  (a) a root registered in solver/contracts.py (a ``KernelContract`` with
      a literal module and qualname),
  (b) a function whose own body calls ``_ext.launch`` or
      ``_ext.raise_on`` (the counted kernel launch points: the kernel
      wrappers and the bound launchers of K1, K5 and K7), or
  (c) a function carrying ``# fleet-audit: hot-path`` on (or immediately
      above) its ``def`` line.

Codes (stable, the reference's, so baselines and SARIF read the same):

  FJ001  error    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``
                  in a hot dispatch: a device->host sync every call
  FJ002  warning  ``float()``/``int()``/``bool()`` on a tensor in a hot
                  dispatch (a hidden sync); declared scalar parameters
                  (analysis/jitspec.static_params) and host fields are
                  exempt
  FJ003  error    ``np.*`` compute call in a hot dispatch (dtype/constant
                  accessors exempt)
  FJ004  error    ``os.environ``/``os.getenv`` read in a hot dispatch:
                  config read on every call instead of before it
  FJ005  warning  blocking call (``time.sleep``, ``subprocess.*``,
                  ``requests.*``, ``urllib.request.*``) inside ``async def``
  FJ006  error    ``await`` inside a ``with <...lock...>:`` block

Suppression: a trailing ``# noqa: FJ00x`` on the offending line (comma
lists and bare ``# noqa`` honored, same grammar ruff uses).

Stdlib-only ON PURPOSE: tools/selflint.py runs this pass in
dependency-free environments, so importing this module must never pull
torch or numpy.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterator, Optional, Union

from ..lint.diagnostics import Diagnostic, Severity
from .callgraph import (_dotted, calls_launch, contract_anchors,
                        hot_marked, module_name_for)
from .jitspec import _is_scalar_annotation, static_params

_Fn = Union[ast.FunctionDef, ast.AsyncFunctionDef]

__all__ = ["HygieneRule", "HYGIENE_RULES", "hygiene_lint_source",
           "hygiene_lint_paths", "iter_python_files", "registered_roots",
           "host_fields", "PACKAGE_ROOT"]

# the port's package directory (module names and the registry anchor here)
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class HygieneRule:
    code: str
    slug: str
    severity: Severity
    doc: str


HYGIENE_RULES: list[HygieneRule] = [
    HygieneRule("FJ001", "host-sync-item", Severity.ERROR,
                "`.item()`/`.tolist()`/`.cpu()`/`.numpy()` in a hot "
                "dispatch forces a device->host sync"),
    HygieneRule("FJ002", "host-cast-tracer", Severity.WARNING,
                "float()/int()/bool() on a tensor in a hot dispatch is a "
                "hidden device->host sync"),
    HygieneRule("FJ003", "numpy-in-jit", Severity.ERROR,
                "np.* compute call in a hot dispatch runs on host"),
    HygieneRule("FJ004", "env-read-in-jit", Severity.ERROR,
                "environment read in a hot dispatch is config read on "
                "every call"),
    HygieneRule("FJ005", "blocking-in-async", Severity.WARNING,
                "blocking call inside an async def stalls the event loop"),
    HygieneRule("FJ006", "await-under-lock", Severity.ERROR,
                "await while holding a threading lock parks the lock "
                "across a scheduling point"),
]

_RULE = {r.code: r for r in HYGIENE_RULES}

# np attributes that are dtype constructors / constants, not compute
_NP_SAFE = {
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool_", "complex64",
    "complex128", "dtype", "pi", "e", "inf", "nan", "newaxis", "ndarray",
    "generic", "integer", "floating", "number", "iinfo", "finfo",
}

# tensor methods that copy to (or wait on) the host (FJ001, FJ010)
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# attribute reads that are host metadata, never tensor values (FJ002, and
# the dataflow pass's taint)
HOST_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "itemsize",
               "nbytes", "layout", "name", "type"}

# call roots considered blocking inside an async def (FJ005)
_BLOCKING_ROOTS = {"subprocess", "requests", "urllib"}

_NOQA = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.I)


def _noqa_codes(line: str) -> Optional[set[str]]:
    """None = no noqa; empty set = bare noqa (suppresses everything)."""
    m = _NOQA.search(line)
    if not m:
        return None
    codes = m.group("codes")
    if not codes:
        return set()
    return {c.strip().upper() for c in codes.split(",") if c.strip()}


def registered_roots(package_root: str = PACKAGE_ROOT) -> set[str]:
    """``module:qualname`` of every dispatch the package's launch-contract
    registry (solver/contracts.py) names."""
    path = os.path.join(package_root, "solver", "contracts.py")
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return set()
    return {f"{m}:{q}" for m, q, _ in contract_anchors(tree)}


def host_fields(trees: list[ast.Module]) -> set[str]:
    """Names of class fields annotated with a scalar type and of
    properties returning one (TorchProblem.S, .real_rows, ...): reading
    them yields a host value, never a tensor."""
    out: set[str] = set()
    for tree in trees:
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in cls.body:
                if isinstance(node, ast.AnnAssign) \
                        and isinstance(node.target, ast.Name) \
                        and _is_scalar_annotation(node.annotation):
                    out.add(node.target.id)
                elif isinstance(node, ast.FunctionDef) \
                        and any(_dotted(d) == "property"
                                for d in node.decorator_list) \
                        and _is_scalar_annotation(node.returns):
                    out.add(node.name)
    return out


class _Ctx:
    """Shared per-file lint state."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 module: str, hot_roots: set[str], fields: set[str]):
        self.path = path
        self.lines = source.splitlines()
        self.tree = tree
        self.module = module
        self.hot_roots = hot_roots
        self.host_attrs = HOST_ATTRS | fields
        # bare names that are blocking calls because of how they were
        # imported: `from time import sleep`, `from subprocess import
        # run`, ... — a dotted call (`time.sleep`) is recognized by its
        # root; the from-import form needs the alias table
        self.blocking_aliases: set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom) or node.module is None:
                continue
            mod_root = node.module.split(".")[0]
            if mod_root in _BLOCKING_ROOTS:
                self.blocking_aliases.update(
                    a.asname or a.name for a in node.names
                    if a.name != "*")
            elif node.module == "time":
                self.blocking_aliases.update(
                    a.asname or a.name for a in node.names
                    if a.name == "sleep")

    def diag(self, code: str, node: ast.AST, message: str,
             function: str = "") -> Optional[Diagnostic]:
        line = getattr(node, "lineno", 0)
        if 0 < line <= len(self.lines):
            codes = _noqa_codes(self.lines[line - 1])
            if codes is not None and (not codes or code in codes):
                return None
        r = _RULE[code]
        return Diagnostic(code=code, severity=r.severity, message=message,
                          file=self.path, line=line,
                          col=getattr(node, "col_offset", 0) + 1,
                          rule=r.slug, function=function)

    def is_hot_root(self, fn: _Fn, qualname: str) -> bool:
        return (f"{self.module}:{qualname}" in self.hot_roots
                or calls_launch(fn) or hot_marked(fn, self.lines))


def _param_names(fn: ast.AST) -> set[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
        return set()
    a = fn.args
    names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _statics(fn: ast.AST) -> set[str]:
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set(static_params(fn)) | {"self", "cls"}
    return set()


def _tensor_loads(expr: ast.AST, ctx: _Ctx) -> set[str]:
    """Names `expr` reads as values, skipping the bases of host-metadata
    attribute reads (``x.shape``, ``prob.real_rows``)."""
    out: set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in ctx.host_attrs:
            return
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
        for c in ast.iter_child_nodes(n):
            visit(c)
    visit(expr)
    return out


def _check_hot_body(root: _Fn, qualname: str, ctx: _Ctx) -> \
        Iterator[Diagnostic]:
    """FJ001-FJ004 over a hot dispatch and everything lexically inside
    it."""
    # names that may hold tensors: every non-static parameter of the root
    # or of any nested def (conservative; locals derived from them are
    # only caught when the expression names a parameter directly)
    tensor_names: set[str] = set()

    def walk(node: ast.AST, where: str) -> Iterator[Diagnostic]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                tensor_names.update(_param_names(child) - _statics(child))
                yield from walk(child, f"{where}.{child.name}")
                continue
            if isinstance(child, ast.Lambda):
                tensor_names.update(_param_names(child))
            if isinstance(child, ast.Call):
                yield from check_call(child, where)
            if isinstance(child, ast.Attribute) \
                    and _dotted(child) == "os.environ":
                d = ctx.diag("FJ004", child,
                             "`os.environ` read in a hot dispatch: config "
                             "read on every call; resolve it before the "
                             "dispatch", where)
                if d:
                    yield d
            yield from walk(child, where)

    def check_call(call: ast.Call, where: str) -> Iterator[Diagnostic]:
        name = _dotted(call.func)
        # FJ001 `.item()` / `.tolist()` / `.cpu()` / `.numpy()`
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in SYNC_METHODS and not call.args:
            d = ctx.diag("FJ001", call,
                         f"`{name or call.func.attr}()` in a hot dispatch: "
                         f"every call is a blocking device->host sync; keep "
                         f"the value on the device or move the read after "
                         f"the dispatch", where)
            if d:
                yield d
        # FJ003 np.* compute
        if name.startswith("np.") or name.startswith("numpy."):
            attr = name.split(".", 1)[1]
            if attr.split(".")[0] not in _NP_SAFE:
                d = ctx.diag("FJ003", call,
                             f"`{name}(...)` in a hot dispatch runs on the "
                             f"host (a copy from the device when handed a "
                             f"tensor); use torch here", where)
                if d:
                    yield d
        # FJ004 os.getenv(...)  (os.environ[...]/.get ride the attribute
        # check — listing the call here would double-report)
        if name in ("os.getenv", "getenv"):
            d = ctx.diag("FJ004", call,
                         f"`{name}(...)` in a hot dispatch: config read on "
                         f"every call; resolve it before the dispatch",
                         where)
            if d:
                yield d
        # FJ002 float()/int()/bool() on a likely tensor
        if name in ("float", "int", "bool") and len(call.args) == 1:
            if _tensor_loads(call.args[0], ctx) & tensor_names:
                d = ctx.diag("FJ002", call,
                             f"`{name}(...)` on a tensor in a hot dispatch "
                             f"is a hidden device->host sync; keep it on "
                             f"the device, or declare the parameter a "
                             f"scalar", where)
                if d:
                    yield d

    tensor_names.update(_param_names(root) - _statics(root))
    yield from walk(root, qualname)


def _check_async(fn: ast.AsyncFunctionDef, ctx: _Ctx) -> \
        Iterator[Diagnostic]:
    """FJ005/FJ006 over one async def's own body (nested defs pruned:
    a sync helper is allowed to block — calling it from the coroutine
    is a run_in_executor decision at the call site — and nested async
    defs get their own visit from the module walk)."""
    for node in _walk_own_body(fn):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            root_name = name.split(".")[0]
            blocking = name == "time.sleep" \
                or root_name in _BLOCKING_ROOTS \
                or (root_name == name and name in ctx.blocking_aliases)
            if blocking:
                d = ctx.diag("FJ005", node,
                             f"blocking call `{name}(...)` inside `async "
                             f"def {fn.name}` stalls the event loop; use "
                             f"asyncio primitives or run_in_executor")
                if d:
                    yield d
        if isinstance(node, ast.With):
            holds_lock = any(
                "lock" in _dotted(item.context_expr.func).lower()
                if isinstance(item.context_expr, ast.Call)
                else "lock" in _dotted(item.context_expr).lower()
                for item in node.items)
            if holds_lock and any(isinstance(n, ast.Await)
                                  for n in ast.walk(node)):
                d = ctx.diag("FJ006", node,
                             f"`await` while holding a threading lock in "
                             f"`async def {fn.name}`: the lock is parked "
                             f"across a scheduling point and sync writers "
                             f"sharing it deadlock; release before "
                             f"awaiting or use an asyncio.Lock")
                if d:
                    yield d


def _walk_own_body(fn: _Fn) -> Iterator[ast.AST]:
    """Walk a function's body WITHOUT descending into nested function
    defs (sync helpers are allowed to block; nested async defs get their
    own visit from the module walk)."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _defs(tree: ast.Module) -> Iterator[tuple[_Fn, str]]:
    """Every function def with its lexical qualname, outer before inner."""
    queue: list[tuple[ast.AST, str]] = [(tree, "")]
    while queue:
        node, prefix = queue.pop(0)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    yield child, q
                queue.append((child, q + "."))
            else:
                queue.append((child, prefix))


def _lint_tree(source: str, path: str, tree: ast.Module, module: str,
               hot_roots: set[str], fields: set[str]) -> list[Diagnostic]:
    ctx = _Ctx(path, source, tree, module, hot_roots, fields)
    out: list[Diagnostic] = []
    # defs already covered by an enclosing hot dispatch's walk: a hot def
    # nested in a hot def must not be scanned twice (_defs yields outer
    # defs first)
    covered: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            # every async def gets its own FJ005/FJ006 scan; _check_async
            # prunes nested defs, so nesting never double-reports
            out.extend(_check_async(node, ctx))
    for fn, qual in _defs(tree):
        if id(fn) in covered or not ctx.is_hot_root(fn, qual):
            continue
        covered.update(id(n) for n in ast.walk(fn)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
        out.extend(_check_hot_body(fn, qual, ctx))
    out.sort(key=lambda d: (d.file or "", d.line, d.col, d.code))
    return out


def hygiene_lint_source(source: str, path: str = "<string>",
                        module: Optional[str] = None,
                        hot_roots: Optional[set[str]] = None) -> \
        list[Diagnostic]:
    """Run every FJ rule over one Python source text. `module` (default:
    the file's stem) and `hot_roots` (``module:qualname`` keys, default
    none) place it against a launch-contract registry."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []        # selflint's syntax check owns parse failures
    return _lint_tree(source, path, tree,
                      module or module_name_for(path, None),
                      hot_roots or set(), host_fields([tree]))


def iter_python_files(roots: list[str]) -> list[str]:
    out: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(out)


def hygiene_lint_paths(roots: list[str], rel_to: Optional[str] = None,
                       package_root: str = PACKAGE_ROOT,
                       hot_roots: Optional[set[str]] = None) \
        -> list[Diagnostic]:
    """Run the FJ rules over files/directories; paths in diagnostics are
    relative to `rel_to` when given (stable spans). Module names anchor at
    `package_root`, whose launch-contract registry gives the hot roots
    unless `hot_roots` is passed."""
    if hot_roots is None:
        hot_roots = registered_roots(package_root)
    parsed = []
    for path in iter_python_files(roots):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        parsed.append((path, source, tree))
    fields = host_fields([t for _p, _s, t in parsed])
    out: list[Diagnostic] = []
    for path, source, tree in parsed:
        rel = os.path.relpath(path, rel_to) if rel_to else path
        out.extend(_lint_tree(source, rel, tree,
                              module_name_for(path, package_root),
                              hot_roots, fields))
    return out
