"""The flagship entry points (counterparts of ``__graft_entry__``).

``entry()`` returns ``(fn, example_args)``: one fixed-budget solve step on
the flagship compute path, a 32-sweep anneal of 8 chains of a 256×16
problem (K3 builds the chains' state, K1 runs each sweep), then the exact
total cost of every chain (K3) and the argmin chain. ``fn(*example_args)``
runs it on the device the problem was staged on.

``dryrun_multichip(n_devices)`` runs the reference's multi-device dry run:
its chain layout over the ranks of the process group when there is one
(``parallel.chain_mesh``), and its sharded layouts on a mesh of
`n_devices` positions that all name one device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import parallel
from .device import resolve_device
from .lower.tensors import synthetic_problem
from .solver import collectives
from .solver.anneal import ChainSlice, anneal, anneal_states
from .solver.api import make_chain_inits
from .solver.buckets import pad_problem
from .solver.kernels import total_cost
from .solver.problem import prepare_problem
from .solver.repair import verify
from .solver.sharded import SVC_AXIS, Mesh, anneal_sharded

__all__ = ["entry", "dryrun_multichip", "ENTRY_STEPS", "ENTRY_CHAINS"]

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


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The reference's multi-device dry run on one device, its three
    layouts on tiny shapes:

    1. chain-sharded: `n_devices` chains of 64×8 (rounded up to a
       multiple of the ranks) anneal for 16 sweeps (K1) and the argmin of
       their total cost (K3) is taken. With a process group of two or more
       ranks the chains spread over ``parallel.chain_mesh()`` (each rank
       anneals its share, the costs are gathered and the winner comes from
       its rank); without one they are the chain axis of one device;
    2. service-axis sharded: S = 64 over the largest shard count <=
       `n_devices` that divides it, 48 sweeps from everything on node 0,
       which must leave fewer violations (K7);
    3. a ragged 61×8 fleet padded with phantom rows over all `n_devices`
       shards, adaptive, which must reach 0 violations on its real rows.

    The sharded layouts' positions name the one device (the card unless
    `device` names the CPU; a rank's own device with a group). Raises
    AssertionError when a layout fails; returns what each layout
    reached."""
    w = parallel.world()
    dev = w.device if w.size >= 2 and device is None else \
        resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pt = synthetic_problem(64, 8, seed=0)
    prob = prepare_problem(pt, dev)
    zeros = torch.zeros(pt.S, dtype=torch.int32, device=dev)
    chains = n_devices
    if w.size >= 2:
        group = parallel.chain_mesh().my_groups()["mesh"]
        chains = w.size * -(-n_devices // w.size)
        rows = ChainSlice(group, group.index * (chains // w.size), chains)
        inits = make_chain_inits(prob, zeros, chains, gen)
        refined = anneal_states(
            prob, inits[rows.c0:rows.c0 + rows.per], gen, steps=16,
            on_mesh=rows).assignment
        every = collectives.all_gather(total_cost(prob, refined), group)
        costs = every.reshape(-1)
        owner, row = divmod(int(torch.argmin(costs)), rows.per)
        best = collectives.broadcast_(
            refined[row].clone() if owner == group.index
            else torch.empty_like(refined[0]), owner, group)
    else:
        inits = make_chain_inits(prob, zeros, chains, gen)
        refined = anneal(prob, inits, gen, steps=16)
        costs = total_cost(prob, refined)
        best = refined[torch.argmin(costs)]
    cost = float(costs.min())
    if best.shape != (pt.S,) or not np.isfinite(cost):
        raise AssertionError(f"chain layout: {tuple(best.shape)}, {cost}")

    d2 = max(d for d in range(1, n_devices + 1) if pt.S % d == 0)
    out = anneal_sharded(prob, zeros, gen, steps=48,
                         mesh=Mesh([dev] * d2, (SVC_AXIS,)))
    before = verify(pt, np.zeros(pt.S, dtype=np.int64))["total"]
    after = verify(pt, out.cpu().numpy())["total"]
    if not after < before:
        raise AssertionError(f"sharded layout: {after} violations, "
                             f"{before} before")

    pt_r = synthetic_problem(61, 8, seed=3)
    padded, orig_s = pad_problem(prepare_problem(pt_r, dev), n_devices)
    ragged = anneal_sharded(
        padded, torch.zeros(padded.S, dtype=torch.int32, device=dev), gen,
        steps=400, mesh=Mesh([dev] * n_devices, (SVC_AXIS,)), adaptive=True,
        block=16, n_real=orig_s)
    stats = verify(pt_r, ragged.cpu().numpy()[:orig_s])
    if stats["total"] != 0:
        raise AssertionError(f"ragged sharded layout infeasible: {stats}")
    return {"chains": chains, "best_cost": cost, "svc_shards": d2,
            "violations_before": int(before), "violations_after": int(after),
            "ragged_padded_S": padded.S, "ragged_violations": 0}
