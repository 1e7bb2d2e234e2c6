"""AST extraction of a hot dispatch's declaration (port of
``analysis/jitspec.py``, under its name so a reader finds the
counterpart).

The reference reads a jitted function's ``static_argnames`` and
``donate_argnums`` off its ``jax.jit`` declaration. PyTorch has no such
declaration: nothing is traced, so no argument value is baked into a
compiled program. What the port pins instead is the dispatch's host-side
parameter surface, read off its ``def`` as a person reads it:

    def _refine(prob, seed_assignment, gen, t0: float, t1: float,
                migration_weight: float, *, chains: int, steps: int, ...):

The keyword-only parameters and the positional ones annotated with a
scalar type (``int``, ``float``, ``bool``, ``str``, or ``Optional`` of one)
are the knobs that select code paths and sizes; they are the contract's
``static_args``. A change that adds a knob to a hot dispatch changes the
extracted declaration, which diffs against the port's launch contract
(analysis/launch_contract.json).

`qualname` resolves as in the reference: a dotted lexical path of function
names (``"_refine"``, ``"SweepLauncher.__call__"``), each part found by a
walk of the enclosing scope. A missing anchor raises LookupError: an audit
must fail loudly when its anchor moved, not pass vacuously.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Union

__all__ = ["JitDecl", "extract_jit_decl", "static_params", "decl_of"]

_Def = Union[ast.FunctionDef, ast.AsyncFunctionDef]

_SCALARS = {"int", "float", "bool", "str"}


@dataclass
class JitDecl:
    """One hot dispatch's declaration, as written in source. The
    reference's ``donated_params`` becomes ``in_place_params``: the
    parameters the launch-contract registry says the dispatch writes in
    place (empty from source alone; the call graph fills it from
    solver/contracts.py)."""
    fn_name: str                          # the function's name
    static_args: list[str] = field(default_factory=list)   # sorted
    in_place_params: list[str] = field(default_factory=list)
    params: list[str] = field(default_factory=list)        # full signature


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_scalar_annotation(node) -> bool:
    """int / float / bool / str, or Optional[...] / X | None of one (a
    string annotation is parsed first)."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(node, ast.Name):
        return node.id in _SCALARS
    if isinstance(node, ast.Subscript) and \
            _dotted(node.value).split(".")[-1] == "Optional":
        return _is_scalar_annotation(node.slice)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        sides = [node.left, node.right]
        rest = [s for s in sides
                if not (isinstance(s, ast.Constant) and s.value is None)]
        return len(rest) == 1 and _is_scalar_annotation(rest[0])
    return False


def _all_params(fn: _Def) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def static_params(fn: _Def) -> list[str]:
    """The declared host knobs of `fn`: its keyword-only parameters and
    its positional ones annotated with a scalar type, sorted."""
    a = fn.args
    out = {p.arg for p in a.kwonlyargs}
    out |= {p.arg for p in (*a.posonlyargs, *a.args)
            if _is_scalar_annotation(p.annotation)}
    return sorted(out)


def decl_of(fn: _Def) -> JitDecl:
    return JitDecl(fn_name=fn.name, static_args=static_params(fn),
                   params=_all_params(fn))


def extract_jit_decl(source: str, qualname: str,
                     filename: str = "<source>") -> JitDecl:
    """Extract the declaration of `qualname` from `source`. Raises
    LookupError when the function cannot be found."""
    tree = ast.parse(source, filename=filename)
    fn = _resolve(tree, qualname.split("."))
    if fn is None:
        raise LookupError(
            f"{filename}: no function on path {qualname!r}")
    return decl_of(fn)


def _resolve(tree: ast.Module, parts: list[str]):
    """The def at the lexical path `parts` (classes may name the scopes
    on the way), or None."""
    scope: ast.AST = tree
    for name in parts:
        nxt = None
        for node in ast.walk(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) \
                    and node.name == name and node is not scope:
                nxt = node
                break
        if nxt is None:
            return None
        scope = nxt
    return scope if isinstance(scope, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) else None
