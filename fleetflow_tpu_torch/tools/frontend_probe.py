"""Run chip_smoke's ``[frontend]``, ``[cp]`` and ``[heal]`` phases alone on
the card.

    python3 fleetflow_tpu_torch/tools/frontend_probe.py

Builds the kernels and the host libraries (the placer, the native KDL
parser and its CPython assembly) as chip_smoke does, prints the
interpreter, the card line and whether this interpreter's ``Python.h``
exists, then runs ``chip_smoke.run_frontend_phase``: the reference bench
pipeline's one fleet as KDL parsed natively and in Python, lowered to
10,602 x 1,000, placed cold and rescheduled twice on ``GpuSolverScheduler()``,
explained, loaded as a two-file project through the fork pool, and every
example stage placed; then ``chip_smoke.run_cp_phase``: that fleet and a
second stage placed through the control plane's ``PlacementService`` on
a store of the parsed servers, two churn bursts, an admission stream and
an explain; then ``chip_smoke.run_heal_phase``: the control plane's
self-healing loop at that width, 1,000 in-process agents, the failure
detector and the reconverger healing one dead node and then a burst of 8.
Its ``[frontend]``, ``[cp]`` and ``[heal]`` lines are chip_smoke's. A
quick check of the front end and the control plane on the card, without
chip_smoke's other phases.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import sysconfig
import time


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from fleetflow_tpu_torch import _ext, core
    from fleetflow_tpu_torch.core import parsecache, serialize
    from fleetflow_tpu_torch.cp import models as cp_models
    from fleetflow_tpu_torch.cp import placement as cp_placement
    from fleetflow_tpu_torch.cp.admission import (AdmissionConfig,
                                                  AdmissionController)
    from fleetflow_tpu_torch.cp.store import Store
    from fleetflow_tpu_torch.lower import fleetgen
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.native import kdl as native_kdl
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.sched import (GpuSolverScheduler,
                                           place_with_fallback,
                                           relax_problem)
    from fleetflow_tpu_torch.solver.api import solve
    from fleetflow_tpu_torch.solver.explain import explain_assignment
    from fleetflow_tpu_torch.solver.repair import verify
    from fleetflow_tpu_torch.solver.resident import ProblemDelta

    if not torch.cuda.is_available():
        print("frontend_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = cs.card_line()
    print(card, flush=True)
    inc = sysconfig.get_paths().get("include") or ""
    print(f"[build] Python.h in {inc}: "
          f"{os.path.isfile(os.path.join(inc, 'Python.h'))}", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: ([_ext.host_library(n)
                                     for n in _ext.HOST_LIBS],
                                    [_ext.host_extension(n)
                                     for n in _ext.HOST_EXTS]))
        _ext.build()
        host.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    _launches, flow, pool = cs.run_frontend_phase(
        torch, np, (_ext, GpuSolverScheduler, ProblemDelta, verify, solve,
                    place_with_fallback, relax_problem, core, serialize,
                    fleetgen, lower, native_kdl, parsecache,
                    explain_assignment), "cuda:0")
    print(f"[frontend] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.run_cp_phase(
        torch, np, (_ext, cp_models, Store, cp_placement,
                    AdmissionController, AdmissionConfig, REGISTRY, verify,
                    fleetgen, core), "cuda:0", flow, pool, card)
    print(f"[cp] phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.run_heal_phase(
        torch, np, (_ext, cp_models, Store, cp_placement, REGISTRY, verify,
                    fleetgen, core), "cuda:0", flow, pool, card)
    print(f"[heal] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
