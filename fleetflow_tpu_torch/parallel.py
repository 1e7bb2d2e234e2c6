"""Ranks: the torch.distributed entry point (port of ``parallel.py``).

The reference scales the solver over more chips with ``jax.distributed``:
every process calls ``initialize`` before first device use, and the
global device list then spans the processes. PyTorch's idiom is one
process a card: every process calls :func:`init_multihost`, which joins
the ``torch.distributed`` process group and fixes the process's device;
a mesh of the port (``solver.sharded.Mesh``) then names RANKS, one
position a rank, and the solver's collectives (``solver/collectives.py``)
run over the group.

Usage (the same program in every process):

    from fleetflow_tpu_torch import parallel
    parallel.init_multihost()                  # env-driven
    mesh = parallel.chain_mesh()               # every rank, 1-D
    res = solve(pt, mesh=mesh, chains=2 * mesh.size)

The rendezvous comes from the arguments, else from the reference's
environment triple FLEET_COORD (``host:port``) / FLEET_NUM_PROCS /
FLEET_PROC_ID, else from torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT (where the reference self-discovers a TPU pod); with none of
them it is a no-op that returns False. The rank's device is
``cuda:<local rank>`` (LOCAL_RANK, else the rank) unless the caller names
one (``device="cpu"``, or ``device="cuda:0"`` for ranks that share a
card). The backend is explicit: ``nccl`` on the card and ``gloo`` on the
CPU by default; ``backend="gloo"`` is how ranks share one card, and
``nccl`` with two ranks on one card raises before NCCL fails on its own.
Nothing swaps one backend for the other.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence

import torch

from .core.errors import DeviceUnavailable, SolverError
from .obs import get_logger, kv

__all__ = ["init_multihost", "chain_mesh", "mesh_info", "is_initialized",
           "world", "shutdown", "rendezvous", "World"]

log = get_logger("parallel")

# the rendezvous waits this long for every rank before it raises
DEFAULT_TIMEOUT_S = 120.0


class World(NamedTuple):
    """This process's place in the group: its rank, the group's size, its
    device and the backend (None without a group)."""
    rank: int
    size: int
    device: Optional[torch.device]
    backend: Optional[str]


_world: Optional[World] = None


def is_initialized() -> bool:
    return _world is not None


def world() -> World:
    """The group as this process sees it; a world of one rank (no device,
    no backend) before :func:`init_multihost`."""
    return _world if _world is not None else World(0, 1, None, None)


def rendezvous(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Optional[dict]:
    """Where the group meets: {coordinator "host:port", num_processes,
    process_id, local_rank} from the arguments, the FLEET_* triple or
    torchrun's environment, in that order; None when nothing names a
    group."""
    env = os.environ
    coordinator = coordinator or env.get("FLEET_COORD")
    if num_processes is None and env.get("FLEET_NUM_PROCS"):
        num_processes = int(env["FLEET_NUM_PROCS"])
    if process_id is None and env.get("FLEET_PROC_ID"):
        process_id = int(env["FLEET_PROC_ID"])
    if coordinator is None and num_processes is None:
        if not (env.get("MASTER_ADDR") and env.get("WORLD_SIZE")):
            return None
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env.get("RANK", "0"))
    if coordinator is None or num_processes is None or process_id is None:
        raise SolverError(
            f"incomplete rendezvous: coordinator={coordinator!r}, "
            f"num_processes={num_processes}, process_id={process_id} (set "
            f"FLEET_COORD, FLEET_NUM_PROCS and FLEET_PROC_ID)")
    if not 0 <= process_id < num_processes:
        raise SolverError(f"process_id {process_id} outside a group of "
                          f"{num_processes}")
    local = env.get("LOCAL_RANK")
    return {"coordinator": coordinator, "num_processes": int(num_processes),
            "process_id": int(process_id),
            "local_rank": int(local) if local else int(process_id)}


def _rank_device(device, local_rank: int,
                 local_device_ids: Optional[Sequence[int]]) -> torch.device:
    if device is None:
        index = (int(local_device_ids[0]) if local_device_ids
                 else local_rank)
        dev = torch.device("cuda", index)
    else:
        dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise SolverError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "init_multihost: this rank needs a CUDA device; pass "
            "device='cpu' to run the ranks on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise DeviceUnavailable(
            f"init_multihost: {dev} but this process sees "
            f"{torch.cuda.device_count()} cards (ranks that share a card "
            f"pass device='cuda:0' and backend='gloo')")
    return dev


def _check_cards(store, rank: int, size: int, dev: torch.device,
                 timeout: datetime.timedelta) -> None:
    """NCCL needs a card a rank: every rank posts its card's UUID to the
    rendezvous store and reads the others'."""
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    store.set(f"fleet/card/{rank}", uuid)
    keys = [f"fleet/card/{r}" for r in range(size)]
    store.wait(keys, timeout)
    cards = [store.get(k).decode() for k in keys]
    shared = sorted({c for c in cards if cards.count(c) > 1})
    if shared:
        ranks = [r for r, c in enumerate(cards) if c in shared]
        raise SolverError(
            f"backend='nccl' needs one card a rank; ranks {ranks} share a "
            f"card (pass backend='gloo' for ranks that share one)")


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids: Optional[Sequence[int]] = None, *,
                   backend: Optional[str] = None, device=None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; every process of it calls this first.

    With no arguments: the FLEET_* triple, else torchrun's environment,
    else a no-op (single-process mode). Returns True when the group is
    active; a second call is a no-op. `device` is the rank's device
    (default ``cuda:<local rank>``, or ``local_device_ids[0]``); `backend`
    defaults to nccl on the card and gloo on the CPU. The rendezvous
    raises after `timeout` seconds when a rank is missing."""
    global _world
    if _world is not None:
        return True
    where = rendezvous(coordinator, num_processes, process_id)
    if where is None:
        log.debug("single-process mode (no coordinator configured)")
        return False
    import torch.distributed as dist

    dev = _rank_device(device, where["local_rank"], local_device_ids)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise SolverError(f"backend must be 'nccl' or 'gloo', got "
                          f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise SolverError("backend='nccl' needs a card a rank; the CPU "
                          "ranks take backend='gloo'")
    rank, size = where["process_id"], where["num_processes"]
    host, _, port = where["coordinator"].rpartition(":")
    if not host or not port.isdigit():
        raise SolverError(f"coordinator must be host:port, got "
                          f"{where['coordinator']!r}")
    td = datetime.timedelta(seconds=float(timeout))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host, int(port), size, rank == 0, timeout=td)
    if backend == "nccl":
        _check_cards(store, rank, size, dev, td)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=td)
    _world = World(rank, size, dev, backend)
    log.info("initialized %s", kv(
        coordinator=where["coordinator"], process=rank, processes=size,
        device=str(dev), backend=backend))
    return True


def shutdown() -> None:
    """Leave the group (destroy it); the process is single again."""
    global _world
    if _world is None:
        return
    import torch.distributed as dist

    from .solver import collectives
    collectives.forget_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chains"):
    """The 1-D mesh over every rank (the first `n_devices`); solve(mesh=)
    spreads its chains over it. Without a group it is the one rank of
    this process."""
    from .solver.sharded import Mesh

    size = world().size
    if n_devices is not None:
        if n_devices > size:
            raise ValueError(
                f"chain_mesh({n_devices}) but only {size} ranks exist "
                f"(did init_multihost run on every process?)")
        size = int(n_devices)
    return Mesh(list(range(size)), (axis,))


def mesh_info() -> dict:
    """Shape of the distributed world, for logs and REST surfaces (the
    reference's keys; ``backend`` is the group's, else the device kind)."""
    w = world()
    if _world is None:
        local = max(torch.cuda.device_count(), 1)
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        local, backend = 1, w.backend
    return {
        "process_index": w.rank,
        "process_count": w.size,
        "local_devices": local,
        "global_devices": w.size if _world is not None else local,
        "backend": backend,
        "distributed": _world is not None,
        "device": None if w.device is None else str(w.device),
    }
