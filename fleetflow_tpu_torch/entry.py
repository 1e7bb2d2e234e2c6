"""The flagship entry point (the counterpart of ``__graft_entry__.entry``).

``entry()`` returns ``(fn, example_args)``: one fixed-budget solve step on
the flagship compute path, a 32-sweep anneal of 8 chains of a 256×16
problem (K3 builds the chains' state, K1 runs each sweep), then the exact
total cost of every chain (K3) and the argmin chain. ``fn(*example_args)``
runs it on the device the problem was staged on. The multi-chip dry run
(``__graft_entry__.dryrun_multichip``) waits for the sharded path.
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .lower.tensors import synthetic_problem
from .solver.anneal import anneal
from .solver.api import make_chain_inits
from .solver.kernels import total_cost
from .solver.problem import prepare_problem

__all__ = ["entry", "ENTRY_STEPS", "ENTRY_CHAINS"]

ENTRY_STEPS = 32
ENTRY_CHAINS = 8


def entry(device=None):
    """(fn, example_args): `fn(inits, seed)` anneals the (8, 256) chain
    starts `inits` for 32 sweeps with a generator seeded from the int
    `seed`, and returns the (256,) int32 assignment of the chain with the
    lowest total cost. On the card unless `device` names the CPU."""
    dev = resolve_device(device)
    pt = synthetic_problem(256, 16, seed=0)
    prob = prepare_problem(pt, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    seed_assignment = torch.zeros(pt.S, dtype=torch.int32, device=dev)
    inits = make_chain_inits(prob, seed_assignment, ENTRY_CHAINS, gen)

    def fwd(inits: torch.Tensor, seed: int) -> torch.Tensor:
        g = torch.Generator(device=inits.device)
        g.manual_seed(int(seed))
        refined = anneal(prob, inits, g, steps=ENTRY_STEPS)
        costs = total_cost(prob, refined)
        return refined[torch.argmin(costs)]

    return fwd, (inits, 0)
