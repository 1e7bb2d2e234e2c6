"""Run chip_smoke's ``[ranks]`` phase alone on the card.

    python3 fleetflow_tpu_torch/tools/ranks_probe.py
    python3 fleetflow_tpu_torch/tools/ranks_probe.py TREE_A TREE_B TREE_B TREE_A

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

With arguments, each is the root of a checkout (a parent's from ``git
archive``, say): each tree's own probe runs in its own interpreter from
that tree, in the order given (A, B, B, A puts drift on both sides), its
lines are printed, and one JSON line a run sums it up: each entry point's
and collective's event ms in a cross-rank sweep (median, min and max over
the four ranks' sweeps 1 to 7; sweep 0 is each rank's warm-up) and the
sweep's total, the collectives' calls and host ms of each rank's anneal
(``collectives.STATS``), rank 0's step walls and the phase's seconds.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

SWEEP = re.compile(r"^\[ranks\] anneal rank (\d+) sweep (\d+): (.*)$")
STATS = re.compile(r"^\[ranks\] anneal rank (\d+): .* collectives \(calls, "
                   r"host ms\) (\{.*\})$")
STEPS = re.compile(r"^\[ranks\] rank 0: .* steps wall ms (\{.*\})$")
PHASE = re.compile(r"^\[ranks\] phase ([0-9.]+) s")


def summary(tree: str, text: str) -> dict:
    """The JSON line of one tree's run (see the module docstring)."""
    split: dict = {}
    out = {"tree": tree, "collectives": {}, "steps_ms": None,
           "phase_s": None}
    for line in text.splitlines():
        m = SWEEP.match(line)
        if m and int(m.group(2)) > 0:
            total = 0.0
            for part in m.group(3).split(", "):
                name, ms, _unit = part.split(" ")
                split.setdefault(name, []).append(float(ms))
                total += float(ms)
            split.setdefault("sweep", []).append(total)
        elif STATS.match(line):
            m = STATS.match(line)
            out["collectives"][m.group(1)] = json.loads(m.group(2))
        elif STEPS.match(line):
            out["steps_ms"] = json.loads(STEPS.match(line).group(1))
        elif PHASE.match(line):
            out["phase_s"] = float(PHASE.match(line).group(1))
    out["split_ms"] = {k: [statistics.median(v), min(v), max(v)]
                       for k, v in split.items()}
    return out


def trees(args: list) -> int:
    rc = 0
    for tree in args:
        probe = os.path.join(os.path.abspath(tree), "fleetflow_tpu_torch",
                             "tools", "ranks_probe.py")
        run = subprocess.run([sys.executable, probe], capture_output=True,
                             text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
            rc = 1
        print(json.dumps(summary(tree, run.stdout)), flush=True)
    return rc


def main() -> int:
    if len(sys.argv) > 1:
        return trees(sys.argv[1:])
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
