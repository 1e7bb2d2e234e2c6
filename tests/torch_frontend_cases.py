"""Shared cases and comparisons of the front-end parity tests
(tests/test_torch_{parser,lower,loader,frontend}.py).

``harvest`` collects the KDL texts that the reference's own tests feed to
its parser: every string literal of a reference test module that holds a
top-level config node. Each is then fed to both packages, so the port is
held to the reference on the reference's whole corpus, and a case added
there is picked up here.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

import numpy as np

TESTS = pathlib.Path(__file__).parent
REPO = TESTS.parent
EXAMPLES = REPO / "examples"

_KEYWORDS = ("service ", "stage ", "server ", "project ", "provider ",
             "variables", "tenant ", "registry ")


def harvest(*modules: str) -> list[str]:
    """The distinct string literals of the named reference test modules
    that hold a config node, in source order."""
    out: list[str] = []
    for name in modules:
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and any(k in node.value for k in _KEYWORDS)
                    and node.value not in out and len(node.value) < 20_000):
                out.append(node.value)
    return out


def run(fn, *args, **kw):
    """("ok", result) or ("error", class name, message): the same failure
    in both packages compares equal."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:      # noqa: BLE001 - compared, not swallowed
        return ("error", type(e).__name__, str(e))


def tensor_diff(a, b) -> list[str]:
    """The fields in which two ProblemTensors (one from each package)
    differ: arrays by dtype and value exactly, lists exactly, the strategy
    by value."""
    bad = []
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and np.array_equal(x, y))
        elif name == "strategy":
            same = x.value == y.value
        else:
            same = x == y and type(x) is type(y)
        if not same:
            bad.append(name)
    return bad
