"""Run chip_smoke's ``[ranks]`` phase alone on the card.

    python3 fleetflow_tpu_torch/tools/ranks_probe.py

Builds the kernels as chip_smoke does, prints the interpreter and the card
line, then runs ``chip_smoke.run_ranks_phase``: four worker processes, each
a rank of a gloo process group on the one card, run the 2x2 tempered
anneal_sharded of the sharded fleet from the one-card run's state and
draws (bit-equal), solve_sharded cold and three warm bursts over the 2x2
ranks, and solve(mesh=) and GpuSolverScheduler(mesh=) over the four ranks
at the headline fleet (equal to the one-card solves), then K7's cross-rank
entry points against their plain versions. Its ``[ranks]`` lines are
chip_smoke's. A quick check of the ranks on the card, without chip_smoke's
other phases.
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
    import numpy as np
    import torch

    import chip_smoke as cs
    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.lower import tensors as lower
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.solver import (anneal, buckets, greedy, problem,
                                            sharded, sharded_ranks)
    from fleetflow_tpu_torch.solver.api import solve
    from fleetflow_tpu_torch.solver.repair import verify
    from fleetflow_tpu_torch.solver.resident import ProblemDelta

    if not torch.cuda.is_available():
        print("ranks_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _ext.build()
    _ext.host_library("ffplacer")
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    pt = lower.synthetic_problem(cs.N_SERVICES, cs.N_NODES, seed=0,
                                 n_tenants=8, port_fraction=0.2,
                                 volume_fraction=0.1)
    recs: dict = {}
    t0 = time.perf_counter()
    cs.run_ranks_phase(
        torch, np, (_ext, sharded, sharded_ranks, problem, buckets, greedy,
                    anneal, solve, GpuSolverScheduler, verify, ProblemDelta),
        lower, dev, card, pt, recs)
    print(f"[ranks] probe {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
