"""The port's dependency-free self-lint (fleetflow_tpu_torch/tools/
selflint.py, the counterpart of scripts/selflint.py) holds the port's own
files to zero findings: syntax, undefined names, unused module-level
imports, and the hygiene and dataflow errors left after the port's
baseline. Each check also fires on a fixture, so a clean run means
something."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SELFLINT = REPO / "fleetflow_tpu_torch" / "tools" / "selflint.py"


def _selflint():
    import importlib.util
    spec = importlib.util.spec_from_file_location("port_selflint", SELFLINT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_selflint_clean():
    """Run as a script, in a fresh interpreter that imports no torch: 0
    findings, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(SELFLINT)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selflint: 0 finding(s)" in out.stderr
    assert out.stdout == ""


def test_selflint_imports_no_torch():
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(SELFLINT)!r}]\n"
            "mod = runpy.run_path(sys.argv[0])\n"
            "mod['check_fj']()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'fleetflow_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_checks_fire_on_fixtures():
    lint = _selflint()
    src = ("import os\nimport json\nfrom typing import Optional\n"
           "def f(x: Optional[int]):\n    return json.dumps(x) + typo\n")
    tree = ast.parse(src)
    assert lint.check_undefined("t.py", tree) == [
        "t.py:5: undefined-name 'typo' is never bound in this module"]
    assert lint.check_unused_imports("t.py", tree, src) == [
        "t.py:1: unused-import 'os' is imported but never used"]
    src_ok = "import os  # noqa: F401\n"
    assert lint.check_unused_imports("t.py", ast.parse(src_ok), src_ok) \
        == []
    assert lint.check_unused_imports("__init__.py", tree, src) == []


def test_covers_the_whole_package_only():
    files = _selflint().iter_py_files()
    rel = {os.path.relpath(f, REPO).split(os.sep)[0] for f in files}
    assert rel == {"fleetflow_tpu_torch"}
    assert any(f.endswith(os.path.join("analysis", "dataflow.py"))
               for f in files)
