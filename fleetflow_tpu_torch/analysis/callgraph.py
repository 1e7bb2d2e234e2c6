"""Interprocedural call graph over Python source, AST only (port of
``analysis/callgraph.py``).

The hygiene pass (FJ001-FJ006) is strictly lexical: it sees a hot
dispatch's own body and nothing past the first call boundary. The dataflow
rules (FJ007, FJ008, FJ010, analysis/dataflow.py) need the step the
lexical pass cannot take — *who calls whom*, across modules, with enough
resolution power to follow the shapes this codebase dispatches through:

  direct calls          ``merge_delta(prob, a)``, ``mod.solve(pt)``
                        through the per-module import table
  methods               ``self.apply_delta(...)`` in a class body;
                        ``ClassName.m(...)``; ``x = ClassName(...)`` then
                        ``x.m()`` (local construction); and a unique-name
                        fallback — ``resident.adopt(x)`` resolves when
                        exactly one class in the graph defines ``adopt``
  functools.partial     ``g = partial(f, ...)`` then ``g(...)``
  decorators            a decorated def still resolves to its own body
                        (``@lru_cache`` does not hide it)
  factory dispatch      ``f(...)(args)``: the inner call resolves to a
                        function whose return is (transitively) a local
                        def; a factory returning an instance of a class
                        with ``__call__`` dispatches that method — the
                        bound launchers (``step = sweep_launcher(...)``
                        then ``step(...)`` is ``SweepLauncher.__call__``,
                        K1's launch; K7's ShardedSweepLauncher alike)
  aliases               a module-level ``g = f`` (``merge_sharded =
                        merge_delta``) resolves to ``f``

Every function that is a hot dispatch (hygiene's cases: registered in
solver/contracts.py, a kernel launch point caller, or marked ``#
fleet-audit: hot-path``) carries a :class:`JitDecl` (``decl``): its
declared host knobs and, for registry entries, the parameters the registry
says it writes in place.

Everything is conservative under-approximation: an unresolvable call is
simply absent from the graph (the dataflow pass treats it as a taint
pass-through, never as evidence of safety). Stdlib-only ON PURPOSE, same
contract as hygiene.py: importing this module must never pull torch or
numpy.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional, Union

from .jitspec import JitDecl, _dotted, decl_of

__all__ = ["CallGraph", "FunctionInfo", "ClassInfo", "build_graph",
           "module_name_for", "contract_anchors", "calls_launch",
           "hot_marked", "is_launch_call", "own_nodes", "HOT_MARK",
           "LAUNCH_CALLS"]

_Def = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# attribute names too generic to resolve through the unique-method-name
# fallback (they collide with dict/str/list builtins constantly)
_GENERIC_METHODS = {
    "get", "items", "keys", "values", "copy", "append", "update", "pop",
    "setdefault", "split", "join", "strip", "format", "read", "write",
    "close", "add", "remove", "clear", "extend", "sort", "index", "count",
    "encode", "decode", "startswith", "endswith", "lower", "upper",
    "replace", "sum", "mean", "min", "max", "reshape", "astype", "item",
    "flatten", "tolist", "all", "any", "set", "put", "send", "recv",
}

# a `# fleet-audit: hot-path` comment on (or immediately above) a def
# marks it as a hot dispatch without a contracts.py entry — the hook the
# canary fixtures use
HOT_MARK = "fleet-audit: hot-path"
# the counted kernel launch points (_ext.py): a caller is a hot dispatch
LAUNCH_CALLS = ("_ext.launch", "_ext.raise_on")


@dataclass
class FunctionInfo:
    """One function/method definition in the graph."""
    module: str                    # dotted module name
    qualname: str                  # lexical path inside the module
    path: str                      # source path (as given to build_graph)
    node: _Def
    cls: Optional[str] = None      # enclosing class lexical qualname
    # the hot-dispatch declaration (the reference's jit declaration),
    # when the function is a hot dispatch
    decl: Optional[JitDecl] = None
    # positional parameter names, then kw-only (for arg->param mapping)
    pos_params: list[str] = field(default_factory=list)
    kw_params: list[str] = field(default_factory=list)
    hot_mark: bool = False         # `# fleet-audit: hot-path` marker

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def all_params(self) -> list[str]:
        return [*self.pos_params, *self.kw_params]

    def is_method(self) -> bool:
        return self.cls is not None and self.pos_params[:1] == ["self"]


@dataclass
class ClassInfo:
    module: str
    qualname: str                  # lexical qualname of the class
    bases: list[str] = field(default_factory=list)   # dotted base names
    methods: dict[str, str] = field(default_factory=dict)  # name -> fn key
    # attributes passed in an in-place position of some dispatch inside
    # the class's own methods: self.<attr> is a slot written in place
    in_place_attrs: set[str] = field(default_factory=set)

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclass
class _Module:
    name: str
    path: str
    tree: ast.Module
    lines: list[str]
    # import alias -> dotted target ("torch",
    # "fleetflow_tpu_torch.solver.api", "fleetflow_tpu_torch.solver.api.solve")
    imports: dict[str, str] = field(default_factory=dict)
    # module-level `g = partial(f, ...)` / `g = f` aliases -> local fn key
    fn_aliases: dict[str, str] = field(default_factory=dict)


def is_launch_call(call: ast.Call) -> bool:
    name = _dotted(call.func)
    return any(name == c or name.endswith("." + c) for c in LAUNCH_CALLS)


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's body WITHOUT descending into nested function
    defs, lambdas or classes."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def hot_marked(fn: _Def, lines: list[str]) -> bool:
    """`# fleet-audit: hot-path` on the def line, the line above it, or a
    decorator's line (or the line above it)."""
    linenos = [fn.lineno, fn.lineno - 1]
    for d in fn.decorator_list:
        linenos += [d.lineno, d.lineno - 1]
    return any(0 < n <= len(lines) and HOT_MARK in lines[n - 1]
               for n in linenos)


def calls_launch(fn: _Def) -> bool:
    """Does `fn`'s own body launch a kernel?"""
    return any(isinstance(n, ast.Call) and is_launch_call(n)
               for n in own_nodes(fn))


def _str_tuple(node: Optional[ast.AST], consts: dict) -> list[str]:
    if isinstance(node, ast.Name):
        node = consts.get(node.id, node)
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def contract_anchors(tree: ast.Module) -> list[tuple[str, str, list[str]]]:
    """(module, qualname, in-place parameters) of every ``KernelContract``
    call with a literal module and qualname in `tree`; the in-place
    parameters are the heads of its ``must_write_in_place`` leaves (a
    tuple literal or a module-level name bound to one)."""
    consts = {t.id: node.value for node in tree.body
              if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or _dotted(node.func).split(".")[-1] != "KernelContract":
            continue
        kws = {kw.arg: kw.value for kw in node.keywords}
        m, q = kws.get("module"), kws.get("qualname")
        if isinstance(m, ast.Constant) and isinstance(q, ast.Constant):
            leaves = _str_tuple(kws.get("must_write_in_place"), consts)
            out.append((m.value, q.value,
                        sorted({x.split(".")[0] for x in leaves})))
    return out


def module_name_for(path: str, package_root: Optional[str]) -> str:
    """Dotted module name for a source path. Files outside the package
    root (e.g. canary fixtures) get their bare stem as the module name."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if package_root:
        root = os.path.abspath(package_root)
        apath = os.path.abspath(path)
        parent = os.path.dirname(root)
        if apath.startswith(root + os.sep) or apath == root:
            rel = os.path.relpath(apath, parent)
            mod = rel[:-3] if rel.endswith(".py") else rel
            mod = mod.replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            return mod
    return stem


def _params(fn: _Def) -> tuple[list[str], list[str]]:
    a = fn.args
    return ([p.arg for p in (*a.posonlyargs, *a.args)],
            [p.arg for p in a.kwonlyargs])


class CallGraph:
    """The package-wide index: functions, classes, imports, hot-dispatch
    declarations."""

    def __init__(self) -> None:
        self.modules: dict[str, _Module] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        # method name -> class keys defining it (unique-name fallback)
        self._method_index: dict[str, list[str]] = {}
        # fn key -> key of the local def its return value IS (for
        # factory-dispatch resolution); "CALL:<key>" marks a transitive
        # hop through the call kept in _returned_call
        self._returned_fn: dict[str, str] = {}
        self._returned_call: dict[str, ast.Call] = {}
        # attribute names that are in-place slots on SOME class (the
        # dataflow view heuristic reads this set)
        self.in_place_attr_names: set[str] = set()

    # -- construction ------------------------------------------------------

    def add_source(self, path: str, source: str, module: str) -> None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return              # selflint's syntax check owns parse errors
        mod = _Module(name=module, path=path, tree=tree,
                      lines=source.splitlines())
        self.modules[module] = mod
        self._index_imports(mod)
        self._index_defs(mod)
        self._index_partials(mod)

    def finalize(self) -> None:
        """Second pass once every module is indexed: the hot-dispatch
        declarations (registry anchors first, so their in-place
        parameters land), module-level plain aliases, then per-class
        in-place slots (needs call resolution, so it must run after all
        defs exist)."""
        for mod in self.modules.values():
            self._index_plain_aliases(mod)
        for mod in self.modules.values():
            for m, q, in_place in contract_anchors(mod.tree):
                fi = self.functions.get(f"{m}:{q}")
                if fi is None and m in self.modules:
                    alias = self.modules[m].fn_aliases.get(q)
                    fi = self.functions.get(alias) if alias else None
                if fi is None:
                    continue
                if fi.decl is None:
                    fi.decl = decl_of(fi.node)
                fi.decl.in_place_params = sorted(
                    set(fi.decl.in_place_params) | set(in_place))
        # only a module that names `_ext` can call a launch point
        launching = {m.name for m in self.modules.values()
                     if any("_ext" in ln for ln in m.lines)}
        for fi in self.functions.values():
            if fi.decl is None and (fi.hot_mark or (
                    fi.module in launching and calls_launch(fi.node))):
                fi.decl = decl_of(fi.node)
        # only a call spelled like an in-place dispatch (or an alias of
        # one) can write a slot in place: resolve those alone
        in_place = {fi.name for fi in self.functions.values()
                    if fi.decl is not None and fi.decl.in_place_params}
        in_place |= {alias for m in self.modules.values()
                     for alias, key in m.fn_aliases.items()
                     if self.functions[key].name in in_place}
        for cls in self.classes.values() if in_place else ():
            for mname, fkey in cls.methods.items():
                fn = self.functions.get(fkey)
                if fn is None:
                    continue
                for call in ast.walk(fn.node):
                    if not isinstance(call, ast.Call) or _dotted(
                            call.func).split(".")[-1] not in in_place:
                        continue
                    decl = self.dispatch_decl(fn, call)
                    if decl is None or not decl.in_place_params:
                        continue
                    for pos, argname in enumerate(decl.params):
                        if argname not in decl.in_place_params:
                            continue
                        if pos < len(call.args):
                            d = _dotted(call.args[pos])
                            if d.startswith("self."):
                                attr = d.split(".", 1)[1]
                                cls.in_place_attrs.add(attr)
                                self.in_place_attr_names.add(attr)

    def _index_imports(self, mod: _Module) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                if node.level:
                    # relative import: resolve against this module's pkg
                    parts = mod.name.split(".")
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + [node.module])
                for a in node.names:
                    if a.name != "*":
                        mod.imports[a.asname or a.name] = f"{base}.{a.name}"

    def _index_defs(self, mod: _Module) -> None:
        def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    pos, kw = _params(child)
                    info = FunctionInfo(
                        module=mod.name, qualname=q, path=mod.path,
                        node=child, cls=cls, pos_params=pos, kw_params=kw,
                        hot_mark=hot_marked(child, mod.lines))
                    self.functions[info.key] = info
                    if cls is not None and "." not in q[len(cls) + 1:]:
                        ck = f"{mod.name}:{cls}"
                        self.classes[ck].methods[child.name] = info.key
                        if child.name not in _GENERIC_METHODS:
                            self._method_index.setdefault(
                                child.name, []).append(ck)
                    self._index_returned_fn(mod, info)
                    visit(child, q + ".", cls)
                elif isinstance(child, ast.ClassDef):
                    q = f"{prefix}{child.name}"
                    self.classes[f"{mod.name}:{q}"] = ClassInfo(
                        module=mod.name, qualname=q,
                        bases=[_dotted(b) for b in child.bases])
                    visit(child, q + ".", q)
                else:
                    visit(child, prefix, cls)

        visit(mod.tree, "", None)

    def _index_returned_fn(self, mod: _Module, info: FunctionInfo) -> None:
        """Record what a factory's return value IS, when statically
        evident: a local def name, or a call (a factory or a constructor,
        stored as a transitive hop). The first return of a breadth-first
        walk counts: the body's own, before one nested in a branch."""
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            v = node.value
            if isinstance(v, ast.Name):
                self._returned_fn[info.key] = \
                    f"{mod.name}:{info.qualname}.{v.id}"
                return
            if isinstance(v, ast.Call):
                self._returned_fn[info.key] = f"CALL:{info.key}"
                self._returned_call[info.key] = v
                return

    def _index_partials(self, mod: _Module) -> None:
        """`g = partial(f, ...)` at module (or any) level: g becomes an
        alias of f."""
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            call = node.value
            if _dotted(call.func) not in ("partial", "functools.partial"):
                continue
            if not call.args or not isinstance(call.args[0], ast.Name):
                continue
            fi = self._find_in_module(mod.name, call.args[0].id)
            if fi is not None:
                mod.fn_aliases[node.targets[0].id] = fi.key

    def _index_plain_aliases(self, mod: _Module) -> None:
        """Module-level `g = f` with `f` a def of this module or an
        imported one: g becomes an alias of f."""
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Name)):
                continue
            fi = self.functions.get(f"{mod.name}:{node.value.id}")
            target = mod.imports.get(node.value.id)
            if fi is None and target and "." in target:
                tmod, _, tname = target.rpartition(".")
                fi = self.functions.get(f"{tmod}:{tname}")
            if fi is not None:
                mod.fn_aliases[node.targets[0].id] = fi.key

    def _find_in_module(self, module: str,
                        name: str) -> Optional[FunctionInfo]:
        """A def called `name` anywhere in `module` (module level
        preferred, then any nesting depth)."""
        fi = self.functions.get(f"{module}:{name}")
        if fi is not None:
            return fi
        for key, cand in self.functions.items():
            if cand.module == module and cand.name == name:
                return cand
        return None

    # -- resolution --------------------------------------------------------

    def resolve_name(self, caller: FunctionInfo,
                     name: str) -> Optional[FunctionInfo]:
        """A bare Name in `caller`'s body -> FunctionInfo, walking the
        lexical scope chain, then module level, then import aliases."""
        mod = self.modules.get(caller.module)
        # lexical chain: caller.qualname prefixes, innermost first
        parts = caller.qualname.split(".")
        for depth in range(len(parts), -1, -1):
            prefix = ".".join(parts[:depth])
            q = f"{prefix}.{name}" if prefix else name
            fi = self.functions.get(f"{caller.module}:{q}")
            if fi is not None:
                return fi
        if mod is not None:
            alias = mod.fn_aliases.get(name)
            if alias is not None:
                return self.functions.get(alias)
            target = mod.imports.get(name)
            if target is not None and "." in target:
                tmod, _, tname = target.rpartition(".")
                fi = self.functions.get(f"{tmod}:{tname}")
                if fi is not None:
                    return fi
                tm = self.modules.get(tmod)
                alias = tm.fn_aliases.get(tname) if tm is not None else None
                if alias is not None:
                    return self.functions.get(alias)
        return None

    def resolve_class(self, module: str, name: str) -> Optional[ClassInfo]:
        ci = self.classes.get(f"{module}:{name}")
        if ci is not None:
            return ci
        mod = self.modules.get(module)
        if mod is not None:
            target = mod.imports.get(name)
            if target and "." in target:
                tmod, _, tname = target.rpartition(".")
                return self.classes.get(f"{tmod}:{tname}")
        return None

    def method_on(self, cls: ClassInfo, name: str, *,
                  _seen: Optional[set] = None) -> Optional[FunctionInfo]:
        """Resolve a method on a class, walking base classes inside the
        graph (single inheritance chains; cycles guarded)."""
        _seen = _seen or set()
        if cls.key in _seen:
            return None
        _seen.add(cls.key)
        fkey = cls.methods.get(name)
        if fkey is not None:
            return self.functions.get(fkey)
        for base in cls.bases:
            bci = self.resolve_class(cls.module, base.split(".")[-1])
            if bci is not None:
                fi = self.method_on(bci, name, _seen=_seen)
                if fi is not None:
                    return fi
        return None

    def returned_class(self, fn: FunctionInfo) -> Optional[ClassInfo]:
        """The class whose instance `fn` returns, when its return value is
        a constructor call (``return SweepLauncher(prob, st, M)``)."""
        call = self._returned_call.get(fn.key)
        if call is not None and isinstance(call.func, ast.Name):
            return self.resolve_class(fn.module, call.func.id)
        return None

    def resolve_call(self, caller: FunctionInfo, call: ast.Call,
                     local_types: Optional[dict] = None) \
            -> Optional[FunctionInfo]:
        """Resolve a call expression to its FunctionInfo, or None.
        `local_types` maps local variable names to ClassInfo keys
        (maintained by the dataflow interpreter for `x = ClassName(...)`
        and `x = factory_returning_an_instance(...)` locals); calling
        such a local is its class's ``__call__``."""
        func = call.func
        if isinstance(func, ast.Name):
            if local_types and func.id in local_types:
                ci = self.classes.get(local_types[func.id])
                if ci is not None:
                    return self.method_on(ci, "__call__")
            fi = self.resolve_name(caller, func.id)
            if fi is not None:
                return fi
            # ClassName(...) -> __init__ (constructor edge)
            ci = self.resolve_class(caller.module, func.id)
            if ci is not None:
                return self.method_on(ci, "__init__")
            return None
        if isinstance(func, ast.Attribute):
            attr = func.attr
            base = func.value
            # self.m(...)
            if isinstance(base, ast.Name) and base.id == "self" \
                    and caller.cls is not None:
                ci = self.classes.get(f"{caller.module}:{caller.cls}")
                if ci is not None:
                    fi = self.method_on(ci, attr)
                    if fi is not None:
                        return fi
            # x.m(...) with x a known-constructed local
            if isinstance(base, ast.Name) and local_types:
                ck = local_types.get(base.id)
                if ck is not None:
                    ci = self.classes.get(ck)
                    if ci is not None:
                        fi = self.method_on(ci, attr)
                        if fi is not None:
                            return fi
            # mod.f(...) / pkg.mod.f(...) through the import table
            dotted = _dotted(func)
            if dotted:
                root = dotted.split(".")[0]
                mod = self.modules.get(caller.module)
                target = mod.imports.get(root) if mod else None
                if target is not None:
                    full = target + dotted[len(root):]
                    tmod, _, tname = full.rpartition(".")
                    fi = self.functions.get(f"{tmod}:{tname}")
                    if fi is not None:
                        return fi
                    tm = self.modules.get(tmod)
                    alias = tm.fn_aliases.get(tname) if tm else None
                    if alias is not None:
                        return self.functions.get(alias)
                    # mod.Class.method
                    parts = full.split(".")
                    if len(parts) >= 3:
                        ci = self.classes.get(
                            ".".join(parts[:-2]) + ":" + parts[-2])
                        if ci is not None:
                            return self.method_on(ci, parts[-1])
            # ClassName.m(...) in the same module
            if isinstance(base, ast.Name):
                ci = self.resolve_class(caller.module, base.id)
                if ci is not None:
                    fi = self.method_on(ci, attr)
                    if fi is not None:
                        return fi
            # unique-method-name fallback: exactly one class defines it
            owners = self._method_index.get(attr, [])
            if len(owners) == 1:
                ci = self.classes.get(owners[0])
                if ci is not None:
                    return self.method_on(ci, attr)
            return None
        if isinstance(func, ast.Call):
            # factory dispatch: f(...)(args) — resolve what f returns
            inner = self.resolve_call(caller, func, local_types)
            if inner is not None:
                ci = self.returned_class(inner)
                if ci is not None:
                    return self.method_on(ci, "__call__")
                return self.returned_callable(inner)
        return None

    def returned_callable(self, fn: FunctionInfo,
                          depth: int = 0) -> Optional[FunctionInfo]:
        """The function `fn`'s return value IS, following factory chains
        up to 8 hops. Decorators on the factories (lru_cache) are ignored
        — the body is what we read."""
        if depth > 8:
            return None
        target = self._returned_fn.get(fn.key)
        if target is None:
            return None
        if target.startswith("CALL:"):
            call = self._returned_call.get(fn.key)
            if call is None:
                return None
            inner = self.resolve_call(fn, call)
            if inner is None:
                return None
            out = self.returned_callable(inner, depth + 1)
            return out if out is not None else inner
        fi = self.functions.get(target)
        if fi is None:
            # `return name` where name is not a local def — maybe a
            # module-level alias or sibling def
            name = target.rsplit(".", 1)[-1]
            fi = self.resolve_name(fn, name)
        return fi

    def dispatch_decl(self, caller: FunctionInfo,
                      call: ast.Call,
                      local_types: Optional[dict] = None) \
            -> Optional[JitDecl]:
        """When `call` dispatches a hot dispatch (directly, through an
        alias or a factory), return its declaration — in-place parameters
        and host knobs included."""
        fi = self.resolve_call(caller, call, local_types)
        if fi is not None and fi.decl is not None:
            return fi.decl
        return None

    def hot_roots(self) -> list[FunctionInfo]:
        return [f for f in self.functions.values() if f.decl is not None]


def build_graph(paths: list[str],
                package_root: Optional[str] = None,
                rel_to: Optional[str] = None) -> CallGraph:
    """Parse every file and build the package call graph. `paths` are
    files; `package_root` (a directory named like the package) anchors
    dotted module names; diagnostics later use the paths verbatim, so
    pass them pre-relativized when stable spans matter."""
    g = CallGraph()
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        shown = os.path.relpath(path, rel_to) if rel_to else path
        g.add_source(shown, source, module_name_for(path, package_root))
    g.finalize()
    return g
