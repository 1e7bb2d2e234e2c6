"""Run chip_smoke's ``[wire]`` phase alone on the card.

    python3 fleetflow_tpu_torch/tools/wire_probe.py

Builds the kernels and the host libraries as chip_smoke does, prints the
interpreter and the card line, parses chip_smoke's [frontend] fleet
(10,000 services, 10,602 rows) and its 1,000 servers, then runs
``chip_smoke.run_wire_phase``: a control-plane server on a socket with
token auth, the servers registered over the wire, ``placement.solve`` of
the fleet, two churn bursts, an explain, 64 streamed arrivals, 100 agents
on the agent channel with a 1,000-service deploy, a heal after one
agent's session closes, and a standby's promotion with a solve on its
fresh scheduler, every placement on the card. Its ``[wire]`` lines are
chip_smoke's. A quick check of the control plane's wire on the card,
without chip_smoke's other phases.
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
    from fleetflow_tpu_torch import _ext, core
    from fleetflow_tpu_torch.lower import fleetgen
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.solver.repair import verify

    if not torch.cuda.is_available():
        print("wire_probe: CUDA is not available", file=sys.stderr)
        return 1
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
    fleet, servers = cs.FRONTEND_FLEET, cs.FRONTEND_SERVERS
    flow = core.parse_kdl_string(fleetgen.generate_fleet_kdl(
        fleet["fleet"], fleet["n_services"], seed=fleet["seed"],
        n_nodes_hint=fleet["n_nodes_hint"], port_base=fleet["port_base"]),
        cache=False)
    pool = core.parse_kdl_string(fleetgen.generate_servers_kdl(
        servers["n"], seed=servers["seed"]), cache=False)
    t0 = time.perf_counter()
    cs.run_wire_phase(torch, np, _ext, REGISTRY, verify, "cuda:0", flow,
                      pool, card)
    print(f"[wire] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
