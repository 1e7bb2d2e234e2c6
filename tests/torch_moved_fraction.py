"""Warm reschedules from batched-seed colds: the fraction of services each
package moves, on the CPU.

Both packages place a fleet cold with ``seed_impl="batched"`` (the
reference's accelerator default and the port's default), the k busiest
nodes of each one's own cold go down, and each reschedules from its own
cold with the given ``prerepair``. ``tests/test_torch_seeds.py`` holds the
port to the reference's moved fraction plus 5 points; run this file to
print the whole grid:

    JAX_PLATFORMS=cpu python tests/torch_moved_fraction.py
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu_torch.solver import solve
from test_torch_problem import make_pair


def kill_busiest(pt, assignment, k: int) -> np.ndarray:
    """node_valid with the k nodes that hold the most services down."""
    valid = pt.node_valid.copy()
    valid[np.argsort(-np.bincount(assignment, minlength=pt.N))[:k]] = False
    return valid


def warm_from_batched_cold(seed: int, kill: int, prerepair,
                           S: int = 320, N: int = 40) -> dict:
    """One reschedule of each package from its own batched cold; the
    forced and moved fractions, the violations and the port's result."""
    ref_pt, port_pt = make_pair(S, N, seed)
    ref_cold = ref_solve(ref_pt, seed=seed, seed_impl="batched")
    cold = solve(port_pt, device="cpu", seed=seed, seed_impl="batched")
    ref_valid = kill_busiest(ref_pt, ref_cold.assignment, kill)
    valid = kill_busiest(port_pt, cold.assignment, kill)
    ref_res = ref_solve(dataclasses.replace(ref_pt, node_valid=ref_valid),
                        init_assignment=ref_cold.assignment,
                        prerepair=prerepair, seed=7)
    res = solve(dataclasses.replace(port_pt, node_valid=valid), device="cpu",
                init_assignment=cold.assignment, prerepair=prerepair, seed=7)
    return dict(
        ref_forced=float((~ref_valid[ref_cold.assignment]).mean()),
        ref_moved=float((ref_res.assignment != ref_cold.assignment).mean()),
        ref_violations=int(ref_res.violations),
        forced=float((~valid[cold.assignment]).mean()),
        moved=float((res.assignment != cold.assignment).mean()),
        valid=valid, result=res)


def main() -> None:
    print("seed kill prerepair | ref forced moved | port forced moved")
    for seed in (4, 5, 6, 8):
        for kill in (1, 3):
            for prerepair in (None, True):
                r = warm_from_batched_cold(seed, kill, prerepair)
                print(f"{seed} {kill} {prerepair} | {r['ref_forced']:.4f} "
                      f"{r['ref_moved']:.4f} | {r['forced']:.4f} "
                      f"{r['moved']:.4f}", flush=True)


if __name__ == "__main__":
    main()
