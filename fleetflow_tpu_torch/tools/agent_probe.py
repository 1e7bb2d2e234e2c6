"""Run chip_smoke's ``[registry]`` and ``[agent]`` phases alone on the card.

    python3 fleetflow_tpu_torch/tools/agent_probe.py [registry] [agent]

Builds the kernels and the host libraries as chip_smoke does, prints the
interpreter and the card line, then runs ``chip_smoke.run_registry_phase``
(8 generated tenant fleets of 1,250 services as project directories and a
fleet-registry.kdl of 1,000 servers, found, parsed and aggregated through
a FlowCache with a fork pool of 4 loaders, placed cold by
``GpuSolverScheduler``, then one fleet regenerated 17 services short,
re-aggregated and re-placed warm by row name) and
``chip_smoke.run_agent_phase`` (a control-plane server on a socket, 100
port ``Agent``s on MockBackends, a 1,000-service deploy placed on the card
and fanned out, the busiest agent stopped and healed, a quadlet and a
compose stage, restart, ping and status). With arguments, only the named
phases run. Their lines are chip_smoke's. A quick check of the registry's
aggregation and the node agent on the card, without chip_smoke's other
phases.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.solver.repair import verify

    if not torch.cuda.is_available():
        print("agent_probe: CUDA is not available", file=sys.stderr)
        return 1
    phases = sys.argv[1:] or ["registry", "agent"]
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: ([_ext.host_library(n)
                                     for n in _ext.HOST_LIBS],
                                    [_ext.host_extension(n)
                                     for n in _ext.HOST_EXTS]))
        _ext.build()
        host.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    if "registry" in phases:
        cs.run_registry_phase(torch, np, _ext, REGISTRY, "cuda:0", card)
    if "agent" in phases:
        cs.run_agent_phase(torch, np, _ext, REGISTRY, verify, "cuda:0", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
