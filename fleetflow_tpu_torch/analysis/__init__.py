"""Static analysis of the port's hot dispatches and of its host-sync and
async hygiene (port of ``fleetflow_tpu.analysis``).

The perf story (warm re-solves move no problem tensor from the host, the
churn merge writes the resident planes where they lie, a rejected attempt
re-seeds from an untouched seed) rests on contracts that runtime checks
only catch when the right leg happens to run. This package pins them:

  auditor    runs each registered hot dispatch (solver/contracts.py) at
             representative bucket tiers on a device and reads the
             contract off the run — in-place writes, kept inputs, output
             dtypes and devices, kernel builds across tiers, and on the
             card the host traffic inside its profiler range — against the
             checked-in contract (analysis/launch_contract.json)
  jitspec    AST extraction of a dispatch's declared host knobs straight
             from source (the reference's jit-declaration reader)
  hygiene    FJ001-FJ006 AST rules over solver/ and cp/ (host syncs,
             numpy and env reads in hot dispatches, blocking calls in
             async handlers, awaits under the store lock), riding the
             lint/ Diagnostic machinery — one function at a time
  callgraph  interprocedural call graph over the package (imports,
             methods, functools.partial, decorators, factory dispatch and
             the bound kernel launchers)
  dataflow   FJ007, FJ008, FJ010 on top of the call graph: host views read
             after an in-place write, tensors reaching host control flow,
             deep host syncs under hot dispatches
  baseline   the accepted-findings ledger (analysis/audit_baseline.json,
             keyed rule+path+function, each entry with its reason)

Surfaces: ``fleet audit kernels`` / ``hygiene`` / ``dataflow`` / ``all``
(cli/main.py), and ``fleetflow_tpu_torch/tools/selflint.py``.
"""

from .baseline import (Baseline, apply_baseline, default_baseline_path,
                       load_baseline, write_baseline)
from .callgraph import CallGraph, build_graph
from .dataflow import (DATAFLOW_RULES, dataflow_lint_paths,
                       dataflow_lint_source, default_hot_roots)
from .hygiene import HYGIENE_RULES, hygiene_lint_paths, hygiene_lint_source
from .jitspec import JitDecl, extract_jit_decl

__all__ = [
    "HYGIENE_RULES",
    "hygiene_lint_paths",
    "hygiene_lint_source",
    "DATAFLOW_RULES",
    "dataflow_lint_paths",
    "dataflow_lint_source",
    "default_hot_roots",
    "CallGraph",
    "build_graph",
    "Baseline",
    "load_baseline",
    "apply_baseline",
    "write_baseline",
    "default_baseline_path",
    "JitDecl",
    "extract_jit_decl",
    "audit_kernels",
    "contract_diff",
    "render_contract",
]


def __getattr__(name: str):
    # the auditor runs the dispatches (torch); keep
    # `import fleetflow_tpu_torch.analysis` torch-free so the source
    # passes stay usable from dependency-free contexts (tools/selflint.py)
    if name in ("audit_kernels", "contract_diff", "render_contract"):
        from . import auditor
        return getattr(auditor, name)
    raise AttributeError(name)
