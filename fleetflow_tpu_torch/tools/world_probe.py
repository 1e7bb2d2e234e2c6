"""Run chip_smoke's ``[world]`` phase alone on the card.

    python3 fleetflow_tpu_torch/tools/world_probe.py

Builds the kernels as chip_smoke does, prints the interpreter and the card
line, then runs ``chip_smoke.run_world_phase``: every scenario of the
chaos pack at seed 7 and its docstring sizing, the acceptance runs
``rolling-kill-selfheal`` and ``cp-failover`` at 1,000 services x 100
nodes x 2 stages, and ``rolling-kill-selfheal`` at its pack size once
more, each world placing on the card, with the phase's checks (no
violation, no host fallback, K1/K3/K4 and K2 or K5 launched, one digest
for the repeated run, the card's memory back after the failover run). Its
``[world]`` lines are chip_smoke's. A quick check of the chaos world on
the card, without chip_smoke's other phases.
"""

from __future__ import annotations

import os
import sys
import time


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.obs.metrics import REGISTRY

    if not torch.cuda.is_available():
        print("world_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _ext.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.run_world_phase(torch, _ext, REGISTRY, card)
    print(f"[world] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
