"""FJ007, FJ008, FJ010 — interprocedural dataflow rules over the call graph
(port of ``analysis/dataflow.py``).

hygiene.py proves what a *single function body* can prove; this module
takes the step past the call boundary. On top of analysis/callgraph.py it
seeds taints at the parameters of every hot dispatch and pushes them
through calls, returns, assignments and field access with a small
fixed-point lattice, then evaluates the rules the lexical pass is blind
to:

  FJ007  error    a read, after a call the launch-contract registry
                  declares in place (solver/contracts.py
                  ``must_write_in_place``), of a ``.numpy()`` /
                  ``np.asarray`` view taken before it: on the CPU such a
                  view shares the tensor's memory, so the read sees the
                  merged values (the torch form of the reference's
                  ``device_get``-view clobber); also a view of an in-place
                  slot escaping without a copy
  FJ008  error    a tensor reaching an ``if``/``while``/``assert`` at any
                  call depth under a hot dispatch: a hidden device->host
                  sync
  FJ010  error    an explicit sync (``.item()``, ``.tolist()``, ``.cpu()``,
                  ``.numpy()``, ``float()``/``int()``/``bool()``,
                  ``np.asarray``/``np.array``) on a tensor one or more
                  calls below a hot dispatch — depth 0 is hygiene's
                  FJ001/FJ002 territory

The reference's FJ009 (an env value feeding a jit static argument) and
FJ011 (a global written at trace time) have no counterpart: nothing is
compiled per argument value, and nothing is traced (ROADMAP, deliberate
differences). They are not registered.

A value's taint is a set of symbolic placeholders P<i> ("whatever the
i-th parameter holds") plus ``view``; joins are set union, transfer
functions only ever add, so per-function summaries recomputed from callee
summaries are monotone and the fixed point (a worklist over the reverse
call edges) terminates. Precision follows the codebase's idioms: a
parameter declared a scalar (``t0: float``) seeds no taint, host
fields (scalar-annotated dataclass fields and properties, TorchProblem.S,
.real_rows) and tensor metadata (``.shape``, ``.numel()``) shed the
taint, and so does the result of an explicit sync — it is a host value,
and the sync itself is the finding. A call of a nested def returns the
taint of what it reads from the enclosing scope (the anneal loops'
closures over their carried state). The body of ``if <x>.device.type ==
"cpu":`` — each kernel wrapper's branch to its plain version — carries
its values but records no sink: it runs on host tensors, with no card to
wait for.

Suppression: trailing ``# noqa: FJ0xx`` (hygiene's grammar), or a
baseline entry keyed rule+path+function (analysis/baseline.py; the port's
deliberate syncs live there, each with its reason). Stdlib-only ON
PURPOSE — tools/selflint.py runs this pass in dependency-free
environments.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field, replace
from typing import Optional, Union

from ..lint.diagnostics import Diagnostic, Severity
from .callgraph import (CallGraph, FunctionInfo, _dotted, build_graph,
                        module_name_for)
from .hygiene import (HOST_ATTRS, PACKAGE_ROOT, SYNC_METHODS, _noqa_codes,
                      host_fields, iter_python_files)
from .jitspec import _is_scalar_annotation

_Def = Union[ast.FunctionDef, ast.AsyncFunctionDef]

__all__ = ["DataflowRule", "DATAFLOW_RULES", "dataflow_lint_paths",
           "dataflow_lint_source", "default_hot_roots"]


@dataclass(frozen=True)
class DataflowRule:
    code: str
    slug: str
    severity: Severity
    doc: str


DATAFLOW_RULES: list[DataflowRule] = [
    DataflowRule("FJ007", "use-after-donate", Severity.ERROR,
                 "a host view of a tensor read after the call that writes "
                 "the tensor in place"),
    DataflowRule("FJ008", "traced-control-flow", Severity.ERROR,
                 "a tensor reaches Python control flow under a hot "
                 "dispatch (a hidden sync)"),
    DataflowRule("FJ010", "deep-host-sync", Severity.ERROR,
                 "explicit host sync on a tensor one or more calls below a "
                 "hot dispatch"),
]

_RULE = {r.code: r for r in DATAFLOW_RULES}

VIEW = "view"          # result aliases a tensor's memory (.numpy() on CPU)

# tensor methods whose result is host metadata
_BENIGN_METHODS = {"numel", "dim", "size", "element_size", "is_contiguous",
                   "stride", "data_ptr", "nelement", "get_device",
                   "storage_offset", "is_floating_point"}
# builtins whose result is a host scalar
_SCALAR_BUILTINS = ("int", "float", "str", "bool", "len", "isinstance",
                    "range", "type", "id", "repr")
# methods that return a view of their base (the buffer stays the same)
_PASS_METHODS = ("cpu", "detach", "contiguous", "view", "reshape",
                 "flatten", "squeeze", "unsqueeze", "view_as")


def _method(call: ast.Call) -> str:
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def _is_np(name: str, leaves: tuple) -> bool:
    parts = name.split(".")
    return len(parts) == 2 and parts[0] in ("np", "numpy") \
        and parts[1] in leaves


def _view_operand(call: ast.Call) -> Optional[ast.AST]:
    """The tensor a call returns a host VIEW of: ``x.numpy()`` and
    ``np.asarray(x)`` (on the CPU both share the tensor's memory)."""
    if _method(call) == "numpy" and not call.args:
        return call.func.value
    if _is_np(_dotted(call.func), ("asarray",)) and call.args:
        return call.args[0]
    return None


def _is_copy_call(call: ast.Call) -> bool:
    name = _dotted(call.func)
    leaf = _method(call) or name.split(".")[-1]
    if leaf in ("copy", "deepcopy", "clone", "ascontiguousarray"):
        return True
    return _is_np(name, ("array",)) or name in ("torch.tensor",
                                                "torch.as_tensor")


def _sync_operand(call: ast.Call) -> Optional[ast.AST]:
    """The tensor an explicit sync call reads on the host, or None."""
    name = _dotted(call.func)
    if _method(call) in SYNC_METHODS and not call.args:
        return call.func.value
    if name in ("float", "int", "bool") and len(call.args) == 1:
        return call.args[0]
    if _is_np(name, ("asarray", "array")) and call.args:
        return call.args[0]
    return None


def _cpu_branch(test: ast.AST) -> bool:
    """``if <x>.type == "cpu":`` (``t.device.type``, ``dev.type``): the
    wrappers' branch to their plain versions for a CPU tensor."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def default_hot_roots(graph: CallGraph) -> set[str]:
    """Function keys of the hot dispatches: the KernelContract(module=...,
    qualname=...) entries of solver/contracts.py (aliases resolved), the
    kernel launch point callers and anything carrying the ``#
    fleet-audit: hot-path`` marker."""
    return {fn.key for fn in graph.hot_roots()}


@dataclass
class Sink:
    kind: str            # "bool" | "sync"
    file: str
    line: int
    col: int
    detail: str          # human fragment for the message
    fn_key: str          # function the sink is lexically in
    depth: int = 0       # call depth below the summarized function


@dataclass
class Summary:
    """What one function does with its parameters — symbolically.

    Recomputed from scratch at each visit (callee summaries are the only
    carried state), so growth is monotone in the callee lattice."""
    # param index -> its taint flows into the return value
    param_to_ret: set[int] = field(default_factory=set)
    # concrete taints the return value carries regardless of params
    ret_taints: set[str] = field(default_factory=set)
    # param index -> sinks its taint reaches here (or in callees)
    param_sinks: dict[int, list[Sink]] = field(default_factory=dict)
    # param indices whose return value is a VIEW of them
    ret_view_of: set[int] = field(default_factory=set)
    # self.<attr> slots a call to this method writes in place (directly or
    # via self.m() calls) — the FJ007 method arm reads this
    in_place_self_slots: set[str] = field(default_factory=set)

    def sig(self) -> tuple:
        return (frozenset(self.param_to_ret), frozenset(self.ret_taints),
                frozenset((k, len(v)) for k, v in self.param_sinks.items()),
                frozenset(self.ret_view_of),
                frozenset(self.in_place_self_slots))


class _Summaries:
    def __init__(self, graph: CallGraph, fields: set[str]):
        self.graph = graph
        self.host_attrs = HOST_ATTRS | fields
        self.summaries: dict[str, Summary] = {
            k: Summary() for k in graph.functions}
        # callee key -> caller keys (the worklist's reverse edges)
        self.callers: dict[str, set[str]] = {}
        self._free: dict[str, set[str]] = {}

    def run(self) -> dict[str, Summary]:
        work = list(self.graph.functions)
        queued = set(work)
        visits = 0
        limit = 12 * max(len(work), 1)       # a bound, as the reference's
        while work and visits < limit:
            key = work.pop()
            queued.discard(key)
            visits += 1
            before = self.summaries[key].sig()
            self._summarize(self.graph.functions[key])
            if self.summaries[key].sig() != before:
                for c in self.callers.get(key, ()):
                    if c not in queued:
                        queued.add(c)
                        work.append(c)
        return self.summaries

    # -- expression taint evaluation --------------------------------------

    def _eval(self, fn: FunctionInfo, expr: ast.AST,
              env: dict[str, set[str]],
              local_types: dict[str, str]) -> set[str]:
        """Taint set of an expression under `env` (name -> taints)."""
        if isinstance(expr, ast.Name):
            return set(env.get(expr.id, ()))
        if isinstance(expr, ast.Attribute):
            if expr.attr in self.host_attrs:
                return set()
            return self._eval(fn, expr.value, env, local_types)
        if isinstance(expr, ast.Subscript):
            return self._eval(fn, expr.value, env, local_types)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out: set[str] = set()
            for e in expr.elts:
                out |= self._eval(fn, e, env, local_types)
            return out
        if isinstance(expr, ast.Dict):
            out = set()
            for v in expr.values:
                if v is not None:
                    out |= self._eval(fn, v, env, local_types)
            return out
        if isinstance(expr, ast.BinOp):
            return self._eval(fn, expr.left, env, local_types) | \
                self._eval(fn, expr.right, env, local_types)
        if isinstance(expr, ast.UnaryOp):
            return self._eval(fn, expr.operand, env, local_types)
        if isinstance(expr, ast.IfExp):
            return (self._eval(fn, expr.body, env, local_types)
                    | self._eval(fn, expr.orelse, env, local_types))
        if isinstance(expr, ast.Compare):
            # `x is None` / `x is not None` are identity checks on the
            # Python structure, never reads of a tensor's value
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return set()
            out = self._eval(fn, expr.left, env, local_types)
            for c in expr.comparators:
                out |= self._eval(fn, c, env, local_types)
            return out
        if isinstance(expr, ast.BoolOp):
            out = set()
            for v in expr.values:
                out |= self._eval(fn, v, env, local_types)
            return out
        if isinstance(expr, ast.Starred):
            return self._eval(fn, expr.value, env, local_types)
        if isinstance(expr, ast.Call):
            return self._eval_call(fn, expr, env, local_types)
        return set()

    def _eval_call(self, fn: FunctionInfo, call: ast.Call,
                   env: dict[str, set[str]],
                   local_types: dict[str, str]) -> set[str]:
        name = _dotted(call.func)
        # host values: metadata, scalars, and what a sync brought back
        if name in _SCALAR_BUILTINS or _method(call) in _BENIGN_METHODS \
                or _sync_operand(call) is not None:
            return set()
        callee = self.graph.resolve_call(fn, call, local_types)
        if callee is not None:
            s = self.summaries.get(callee.key)
            if s is not None:
                out = set(s.ret_taints)
                # a closure returns what it reads of the enclosing scope
                if callee.qualname.startswith(fn.qualname + "."):
                    for name in self._free_vars(callee):
                        out |= env.get(name, set())
                mapping = self._map_args(callee, call)
                for pi in s.param_to_ret:
                    expr_i = mapping.get(pi)
                    if expr_i is not None:
                        out |= self._taint_of_arg(fn, call, expr_i, env,
                                                  local_types)
                return out
        # unresolved: conservative pass-through of argument taints (and of
        # the receiver's, for a method: `x.sum()` keeps x's)
        joined: set[str] = set()
        if isinstance(call.func, ast.Attribute):
            joined |= self._eval(fn, call.func.value, env, local_types)
        for a in call.args:
            joined |= self._eval(fn, a, env, local_types)
        for kw in call.keywords:
            joined |= self._eval(fn, kw.value, env, local_types)
        return joined

    def _free_vars(self, fn: FunctionInfo, _seen=None) -> set[str]:
        """Names a nested def reads from its enclosing scope: loaded in
        its body, neither its parameters nor bound in it, and those of
        the sibling defs it calls by name."""
        out = self._free.get(fn.key)
        if out is not None:
            return out
        loads, bound = set(), set(fn.all_params)
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Name):
                (loads if isinstance(n.ctx, ast.Load) else bound).add(n.id)
            elif isinstance(n, ast.arg):
                bound.add(n.arg)
        out = loads - bound
        seen = (_seen or set()) | {fn.key}
        scope = fn.qualname.rpartition(".")[0]
        for name in sorted(out):
            sib = self.graph.functions.get(f"{fn.module}:{scope}.{name}")
            if sib is not None and sib.key not in seen:
                out = out | self._free_vars(sib, seen)
        if _seen is None:
            self._free[fn.key] = out
        return out

    def _taint_of_arg(self, fn: FunctionInfo, call: ast.Call,
                      expr_i: Union[int, str],
                      env: dict[str, set[str]],
                      local_types: dict[str, str]) -> set[str]:
        if isinstance(expr_i, int):
            if expr_i < len(call.args):
                return self._eval(fn, call.args[expr_i], env, local_types)
            return set()
        for kw in call.keywords:
            if kw.arg == expr_i:
                return self._eval(fn, kw.value, env, local_types)
        return set()

    def _map_args(self, callee: FunctionInfo, call: ast.Call) \
            -> dict[int, Union[int, str, None]]:
        """callee param index -> caller arg position (int) or kw name.
        Methods skip the self slot; positions past a *args expansion are
        unmapped (conservative)."""
        params = callee.all_params
        offset = 1 if callee.is_method() else 0
        out: dict[int, Union[int, str, None]] = {}
        for i, p in enumerate(params):
            if i < offset:
                continue
            pos = i - offset
            if pos < len(call.args) \
                    and not any(isinstance(a, ast.Starred)
                                for a in call.args[:pos + 1]):
                out[i] = pos
            else:
                out[i] = p if any(kw.arg == p for kw in call.keywords) \
                    else None
        return out

    # -- per-function summarization ---------------------------------------

    def _summarize(self, fn: FunctionInfo) -> None:
        s = Summary()
        params = fn.all_params
        # a parameter declared a scalar (``t0: float``) holds a host value
        a = fn.node.args
        scalars = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
                   if _is_scalar_annotation(p.annotation)}
        env: dict[str, set[str]] = {p: {f"P{i}"}
                                    for i, p in enumerate(params)
                                    if p not in scalars}
        local_types: dict[str, str] = {}

        def sink(kind: str, node: ast.AST, detail: str) -> Sink:
            return Sink(kind=kind, file=fn.path,
                        line=getattr(node, "lineno", 0),
                        col=getattr(node, "col_offset", 0) + 1,
                        detail=detail, fn_key=fn.key)

        def add_sink(pi: int, snk: Sink) -> None:
            lst = s.param_sinks.setdefault(pi, [])
            if not any(x.line == snk.line and x.col == snk.col
                       and x.kind == snk.kind and x.file == snk.file
                       for x in lst):
                lst.append(snk)

        quiet: list = []        # inside a CPU branch: no sinks

        def record(taints: set[str], snk: Sink) -> None:
            if quiet:
                return
            for t in taints:
                if t.startswith("P"):
                    add_sink(int(t[1:]), snk)

        def resolve(call: ast.Call) -> Optional[FunctionInfo]:
            callee = self.graph.resolve_call(fn, call, local_types)
            if callee is not None:
                self.callers.setdefault(callee.key, set()).add(fn.key)
            return callee

        def handle_call(call: ast.Call) -> None:
            tgt = _sync_operand(call)
            if tgt is not None:
                label = _dotted(call.func) or _method(call)
                record(self._eval(fn, tgt, env, local_types),
                       sink("sync", call, f"`{label}(...)`"))
            decl = self.graph.dispatch_decl(fn, call, local_types)
            if decl is not None and decl.in_place_params:
                for pos, pname in enumerate(decl.params):
                    if pname in decl.in_place_params \
                            and pos < len(call.args) \
                            and not any(isinstance(a, ast.Starred)
                                        for a in call.args[:pos + 1]):
                        d = _dotted(call.args[pos])
                        if d.startswith("self."):
                            s.in_place_self_slots.add(d.split(".", 1)[1])
            # inherit the resolved callee's symbolic sinks, one deeper
            callee = resolve(call)
            if callee is None:
                return
            cs = self.summaries.get(callee.key)
            if cs is None:
                return
            if isinstance(call.func, ast.Attribute) \
                    and _dotted(call.func.value) == "self":
                s.in_place_self_slots |= cs.in_place_self_slots
            mapping = self._map_args(callee, call)
            for pi, sinks in cs.param_sinks.items():
                expr_i = mapping.get(pi)
                if expr_i is None:
                    continue
                taints = self._taint_of_arg(fn, call, expr_i, env,
                                            local_types)
                if not taints:
                    continue
                for snk in sinks:
                    record(taints, replace(snk, depth=snk.depth + 1))

        def bind(tgt: ast.AST, taints: set[str]) -> None:
            if isinstance(tgt, ast.Name):
                env[tgt.id] = set(taints)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for e in tgt.elts:
                    bind(e, taints)
            elif isinstance(tgt, ast.Starred):
                bind(tgt.value, taints)

        def handle_assign(targets: list[ast.AST], value: ast.AST) -> None:
            taints = self._eval(fn, value, env, local_types)
            for tgt in targets:
                bind(tgt, taints)
                if isinstance(tgt, ast.Name) and isinstance(value, ast.Call):
                    ci = None
                    if isinstance(value.func, ast.Name):
                        ci = self.graph.resolve_class(fn.module,
                                                      value.func.id)
                    if ci is None:
                        callee = resolve(value)
                        ci = (self.graph.returned_class(callee)
                              if callee is not None else None)
                    if ci is not None:
                        local_types[tgt.id] = ci.key

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue        # nested defs summarize themselves
                if isinstance(child, ast.If) and _cpu_branch(child.test) \
                        and not quiet:
                    # the plain versions' branch: host tensors, no card to
                    # wait for — its values flow, its syncs are no sinks
                    quiet.append(True)
                    for stmt in child.body:
                        walk(ast.Module(body=[stmt], type_ignores=[]))
                    quiet.pop()
                    for stmt in child.orelse:
                        walk(ast.Module(body=[stmt], type_ignores=[]))
                    continue
                if isinstance(child, ast.Assign):
                    handle_assign(child.targets, child.value)
                elif isinstance(child, ast.AnnAssign) \
                        and child.value is not None:
                    handle_assign([child.target], child.value)
                elif isinstance(child, ast.Return) \
                        and child.value is not None:
                    for t in self._eval(fn, child.value, env, local_types):
                        if t.startswith("P"):
                            s.param_to_ret.add(int(t[1:]))
                        else:
                            s.ret_taints.add(t)
                    v = child.value
                    op = _view_operand(v) if isinstance(v, ast.Call) \
                        else None
                    if op is not None:
                        for t in self._eval(fn, op, env, local_types):
                            if t.startswith("P"):
                                s.ret_view_of.add(int(t[1:]))
                        s.ret_taints.add(VIEW)
                elif isinstance(child, (ast.If, ast.While)):
                    record(self._eval(fn, child.test, env, local_types),
                           sink("bool", child.test,
                                "an `if`/`while` condition"))
                elif isinstance(child, ast.Assert):
                    record(self._eval(fn, child.test, env, local_types),
                           sink("bool", child.test, "an `assert`"))
                if isinstance(child, ast.Call):
                    handle_call(child)
                walk(child)

        walk(fn.node)
        self.summaries[fn.key] = s


# ---------------------------------------------------------------------------
# FJ007: a view read after an in-place write, statement-ordered
# ---------------------------------------------------------------------------

class _ViewChecker:
    """Walks one function's statements in source order tracking which
    local names are live host VIEWS of which buffers, and which buffers a
    call has written in place.

    Buffers are named by spelling: a local is its own buffer (``a``), an
    attribute chain is a slot buffer (``resident.assignment``). In-place
    events come from (a) a call of a dispatch the registry declares in
    place, resolved through the call graph — each argument in an in-place
    position is written — and (b) a method call whose summary says it
    writes ``self`` slots in place (``resident.apply_delta(...)`` writes
    ``resident.prob`` and ``resident.assignment``). Copies
    (``np.array``, ``.copy()``, ``.clone()``) launder a view back into an
    owned buffer.
    """

    def __init__(self, graph: CallGraph, summaries: dict[str, Summary],
                 fn: FunctionInfo):
        self.graph = graph
        self.summaries = summaries
        self.fn = fn
        self.views: dict[str, set[str]] = {}      # name -> viewed buffers
        self.alias: dict[str, str] = {}           # name -> attr buffer
        self.written: dict[str, int] = {}         # buffer -> line
        self.local_types: dict[str, str] = {}
        self.findings: list[tuple[ast.AST, str]] = []

    def _buffer(self, expr: ast.AST) -> set[str]:
        """The buffers `expr` denotes, through view-preserving methods,
        slices and plain aliases."""
        while isinstance(expr, ast.Call) and _method(expr) in _PASS_METHODS:
            expr = expr.func.value
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Name):
            if expr.id in self.views:
                return set(self.views[expr.id])
            if expr.id in self.alias:
                return {self.alias[expr.id]}
        d = _dotted(expr)
        return {d} if d else set()

    # buffers an expression's value is a host view of; empty = owned
    def _view_sources(self, expr: ast.AST) -> set[str]:
        if isinstance(expr, ast.Name):
            return set(self.views.get(expr.id, ()))
        if isinstance(expr, ast.Subscript):
            return self._view_sources(expr.value)
        if isinstance(expr, ast.Call):
            if _is_copy_call(expr):
                return set()
            op = _view_operand(expr)
            if op is not None:
                return self._buffer(op)
            callee = self.graph.resolve_call(self.fn, expr,
                                             self.local_types)
            if callee is not None:
                cs = self.summaries.get(callee.key)
                if cs is not None and cs.ret_view_of:
                    out: set[str] = set()
                    for pi in cs.ret_view_of:
                        pos = pi - (1 if callee.is_method() else 0)
                        if 0 <= pos < len(expr.args):
                            out |= self._buffer(expr.args[pos])
                    return out
        return set()

    def _header_nodes(self, stmt: ast.stmt) -> list[ast.AST]:
        """Nodes belonging to this statement's own expressions, NOT to
        nested statement bodies (those get their own `_step`)."""
        nested: list[ast.stmt] = []
        for attr in ("body", "orelse", "finalbody"):
            v = getattr(stmt, attr, None)
            if isinstance(v, list) and v and isinstance(v[0], ast.stmt):
                nested.extend(v)
        for h in getattr(stmt, "handlers", []) or []:
            nested.extend(h.body)
        skip = {id(n) for s in nested for n in ast.walk(s)}
        return [n for n in ast.walk(stmt) if id(n) not in skip]

    def _writes_of(self, nodes: list[ast.AST]) -> set[str]:
        """Buffers the calls among `nodes` write in place."""
        out: set[str] = set()
        for call in (n for n in nodes if isinstance(n, ast.Call)):
            decl = self.graph.dispatch_decl(self.fn, call, self.local_types)
            if decl is not None and decl.in_place_params:
                for pos, pname in enumerate(decl.params):
                    if pname not in decl.in_place_params:
                        continue
                    if pos < len(call.args) and not any(
                            isinstance(a, ast.Starred)
                            for a in call.args[:pos + 1]):
                        out |= self._buffer(call.args[pos])
                for kw in call.keywords:
                    if kw.arg in decl.in_place_params:
                        out |= self._buffer(kw.value)
            if isinstance(call.func, ast.Attribute):
                callee = self.graph.resolve_call(self.fn, call,
                                                 self.local_types)
                if callee is not None:
                    cs = self.summaries.get(callee.key)
                    if cs is not None and cs.in_place_self_slots:
                        base = _dotted(call.func.value)
                        for attr in cs.in_place_self_slots:
                            out.add(f"{base}.{attr}")
        return out

    def check(self) -> list[tuple[ast.AST, str]]:
        self._run_body(self.fn.node.body)
        return self.findings

    def _run_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            self._step(stmt)
            for attr in ("body", "orelse", "finalbody"):
                sub_body = getattr(stmt, attr, None)
                if isinstance(sub_body, list) and sub_body \
                        and isinstance(sub_body[0], ast.stmt):
                    self._run_body(sub_body)
            for h in getattr(stmt, "handlers", []) or []:
                self._run_body(h.body)

    def _step(self, stmt: ast.stmt) -> None:
        nodes = self._header_nodes(stmt)
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                               else [t])
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) \
                and getattr(stmt, "value", None) is not None:
            targets = [stmt.target]
        target_ids = {id(n) for t in targets for n in ast.walk(t)}

        # 1. reads of views whose buffer an earlier call wrote in place
        for n in nodes:
            if id(n) in target_ids or not isinstance(n, ast.Name) \
                    or not isinstance(n.ctx, ast.Load):
                continue
            stale = self.views.get(n.id, set()) & set(self.written)
            if stale:
                buf = sorted(stale)[0]
                self.findings.append((
                    n,
                    f"`{n.id}` is a host view of `{buf}`, written in place "
                    f"on line {self.written[buf]} — on the CPU `.numpy()` / "
                    f"`np.asarray` share the tensor's memory, so this read "
                    f"sees the merged values; copy with "
                    f"`np.array(..., copy=True)` before the write"))

        # 2. escape arm: returning/storing a live view of an in-place SLOT
        #    without a copy — the next warm merge writes the slot in place
        escape_val: Optional[ast.AST] = None
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            escape_val = stmt.value
        elif isinstance(stmt, ast.Assign) \
                and any(isinstance(t, ast.Attribute) for t in targets):
            escape_val = stmt.value
        if escape_val is not None:
            escaping = [n for n in ast.walk(escape_val)
                        if isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Load)]
            if isinstance(escape_val, ast.Call) \
                    and not _is_copy_call(escape_val):
                escaping.append(escape_val)
            for n in escaping:
                srcs = (self.views.get(n.id, set()) if isinstance(n, ast.Name)
                        else self._view_sources(n))
                slots = {b for b in srcs if "." in b and b.split(".")[-1]
                         in self.graph.in_place_attr_names}
                if slots:
                    buf = sorted(slots)[0]
                    label = n.id if isinstance(n, ast.Name) else "the value"
                    self.findings.append((
                        n,
                        f"`{label}` is a host view of in-place slot "
                        f"`{buf}` and escapes this function without a copy "
                        f"— the next merge writes the slot in place and "
                        f"changes it under the holder; materialize with "
                        f"`np.array(..., copy=True)` first"))
                    break

        # 3. this statement's in-place writes land
        for b in self._writes_of(nodes):
            self.written.setdefault(b, stmt.lineno)

        # 4. bindings: views/aliases propagate through plain assignments
        if isinstance(stmt, ast.Assign):
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                srcs = self._view_sources(stmt.value)
                if srcs:
                    self.views[t.id] = srcs
                else:
                    self.views.pop(t.id, None)
                if isinstance(stmt.value, ast.Attribute):
                    self.alias[t.id] = _dotted(stmt.value)
                else:
                    self.alias.pop(t.id, None)
                if isinstance(stmt.value, ast.Call) \
                        and isinstance(stmt.value.func, ast.Name):
                    ci = self.graph.resolve_class(self.fn.module,
                                                  stmt.value.func.id)
                    if ci is not None:
                        self.local_types[t.id] = ci.key


# ---------------------------------------------------------------------------
# rule evaluation over the whole graph
# ---------------------------------------------------------------------------

def _analyze(graph: CallGraph) -> list[Diagnostic]:
    fields = host_fields([m.tree for m in graph.modules.values()])
    summaries = _Summaries(graph, fields).run()
    out: list[Diagnostic] = []
    seen: set[tuple] = set()

    def emit(code: str, file: str, line: int, col: int, message: str,
             function: str) -> None:
        key = (code, file, line, col)
        if key in seen:
            return
        seen.add(key)
        r = _RULE[code]
        out.append(Diagnostic(
            code=code, severity=r.severity, message=message, file=file,
            line=line, col=col, rule=r.slug, function=function))

    def fn_of(key: str) -> str:
        return key.split(":", 1)[1] if ":" in key else key

    # FJ008 / FJ010: symbolic sinks reached from a hot dispatch's tensor
    # parameters (its declared host knobs and `self` are not tensors)
    for root in graph.hot_roots():
        s = summaries.get(root.key)
        if s is None:
            continue
        statics = set(root.decl.static_args) | {"self", "cls"}
        for i, p in enumerate(root.all_params):
            if p in statics:
                continue
            for snk in s.param_sinks.get(i, []):
                deep = f" {snk.depth} call(s) deep" if snk.depth else ""
                if snk.kind == "bool":
                    emit("FJ008", snk.file, snk.line, snk.col,
                         f"tensor (param `{p}` of hot dispatch "
                         f"`{root.qualname}`) reaches {snk.detail}{deep} — "
                         f"Python branching on a tensor is a hidden "
                         f"device->host sync; keep the decision on the "
                         f"device (torch.where) or read it once, "
                         f"deliberately",
                         fn_of(snk.fn_key))
                elif snk.kind == "sync" and snk.depth >= 1:
                    emit("FJ010", snk.file, snk.line, snk.col,
                         f"explicit host sync {snk.detail} on a tensor "
                         f"(param `{p}` of hot dispatch `{root.qualname}`),"
                         f"{deep} — a device round-trip per dispatch; keep "
                         f"it on the device or move it past the dispatch",
                         fn_of(snk.fn_key))

    # FJ007: statement-ordered view tracking, in every function that
    # takes a view (directly, or through a callee returning one)
    viewing = {graph.functions[k].name for k, sm in summaries.items()
               if sm.ret_view_of}
    for key, fn in graph.functions.items():
        if not any(isinstance(n, ast.Call)
                   and (_view_operand(n) is not None
                        or (_method(n) or _dotted(n.func)) in viewing)
                   for n in ast.walk(fn.node)):
            continue
        for node, message in _ViewChecker(graph, summaries, fn).check():
            emit("FJ007", fn.path, getattr(node, "lineno", 0),
                 getattr(node, "col_offset", 0) + 1, message, fn.qualname)

    # noqa suppression against the real source lines, then stable order
    lines_by_path = {m.path: m.lines for m in graph.modules.values()}
    kept: list[Diagnostic] = []
    for d in out:
        lines = lines_by_path.get(d.file or "", [])
        if d.line and d.line <= len(lines):
            codes = _noqa_codes(lines[d.line - 1])
            if codes is not None and (not codes or d.code in codes):
                continue
        kept.append(d)
    kept.sort(key=lambda d: (d.file or "", d.line, d.col, d.code))
    return kept


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def dataflow_lint_paths(roots: list[str],
                        rel_to: Optional[str] = None,
                        package_root: str = PACKAGE_ROOT) \
        -> list[Diagnostic]:
    """Run the dataflow rules over files/directories. `package_root`
    anchors dotted module names (the port's package directory by
    default) so the registry's anchors resolve; paths in diagnostics are
    relative to `rel_to` when given (stable spans)."""
    graph = build_graph(iter_python_files(roots),
                        package_root=package_root, rel_to=rel_to)
    return _analyze(graph)


def dataflow_lint_source(source: str,
                         path: str = "<string>") -> list[Diagnostic]:
    """Run the dataflow rules over one source text (fixtures, tests)."""
    graph = CallGraph()
    graph.add_source(path, source, module_name_for(path, None))
    graph.finalize()
    return _analyze(graph)
