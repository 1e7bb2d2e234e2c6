"""Run chip_smoke's ``[cli]`` phase alone on the card.

    python3 fleetflow_tpu_torch/tools/cli_probe.py

Builds the kernels and the host libraries as chip_smoke does, prints the
interpreter and the card line, then runs ``chip_smoke.run_cli_phase``: the
operator's entry points on the card (``fleet solve`` of the 10,602 x 1,000
fleet in process and as ``python -m fleetflow_tpu_torch.cli``, the
``fleetflowd`` daemon with a placement, a churn re-solve, ``fleet cp
placement state``/``explain`` and ``/metrics``, ``fleet cp registry
solve`` at 10,619 x 1,000, the MCP server's ``fleet_solve`` over stdio,
``fleet chaos run`` and ``fleet plan simulate``). Its lines are
chip_smoke's. A quick check of the entry points on the card, without
chip_smoke's other phases.
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
        print("cli_probe: CUDA is not available", file=sys.stderr)
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
    cs.run_cli_phase(torch, np, _ext, REGISTRY, verify, "cuda:0", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
