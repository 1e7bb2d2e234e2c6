"""Device-resident problem representation (port of ``solver/problem.py``).

Converts host ProblemTensors (numpy) into a ``TorchProblem`` of tensors on
one device, staged once and reused across re-solves. As in the reference,
the three anti-affinity families (host ports, exclusive volumes, explicit
anti-affinity groups) are unified into ONE conflict-id space: a service
carries up to K conflict ids (padded -1); two services conflict iff they
share an id and land on the same node. No S x S matrix exists.

Packed layout (default, ``FLEET_PACKED`` unset or on): the eligibility plane
is bit-packed, bit ``n % 32`` of word ``n // 32`` of row s is eligible[s, n],
and an absent preference plane stays ``None``. The reference stores the
words as uint32; here they are int32 with the same bits, because torch's CPU
uint32 has no ``>>`` or ``gather``. An arithmetic shift followed by ``& 1``
reads the same bit, so every lookup stays exact. ``packed=False`` is the
dense (S, N) bool layout.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.model import PlacementStrategy
from ..lower.tensors import ProblemTensors
from ..obs.metrics import REGISTRY

__all__ = ["TorchProblem", "TENSOR_FIELDS", "STRATEGY_CODES", "PLANE_PACK",
           "packed_width", "packed_enabled", "pack_bool_rows",
           "eligible_lookup", "eligible_row", "eligible_rows",
           "prepare_problem", "unify_conflict_ids", "record_plane_bytes"]

STRATEGY_CODES = {
    PlacementStrategy.SPREAD_ACROSS_POOL: 0,
    PlacementStrategy.PACK_INTO_DEDICATED: 1,
    PlacementStrategy.FILL_LOWEST: 2,
}

PLANE_PACK = 32  # bits per packed eligibility word


def packed_width(n: int) -> int:
    """Words per packed eligibility row: ceil(n / 32)."""
    return -(-max(int(n), 1) // PLANE_PACK)


def packed_enabled(default: bool = True) -> bool:
    """FLEET_PACKED gate (default on): bit-packed eligible plane + absent
    preferred plane at staging time."""
    v = os.environ.get("FLEET_PACKED", "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


def pack_bool_rows(mask: np.ndarray) -> np.ndarray:
    """Host pack: (..., N) bool -> (..., ceil(N/32)) int32 words, bit j of
    word w is column 32*w + j (little-endian). Trailing pad bits of the last
    word are SET, as in the reference, so an all-True row packs to all-ones
    words (-1 as int32). The bits equal the reference's uint32 words."""
    mask = np.ascontiguousarray(np.asarray(mask, dtype=bool))
    N = mask.shape[-1]
    W = packed_width(N)
    b = np.packbits(mask, axis=-1, bitorder="little")
    pad = W * 4 - b.shape[-1]
    if pad:
        b = np.concatenate(
            [b, np.full(b.shape[:-1] + (pad,), 0xFF, np.uint8)], axis=-1)
    out = np.ascontiguousarray(b).view(np.uint32)
    rem = N % PLANE_PACK
    if rem:
        out[..., -1] |= np.uint32((0xFFFFFFFF << rem) & 0xFFFFFFFF)
    return out.view(np.int32)


def eligible_lookup(eligible: torch.Tensor, s, node) -> torch.Tensor:
    """eligible[s, node] as bool for either layout; `s`/`node` broadcast
    like fancy indices."""
    if eligible.dtype == torch.bool:
        return eligible[s, node]
    node = torch.as_tensor(node, device=eligible.device)
    word = eligible[s, node >> 5]
    return ((word >> (node & 31)) & 1).bool()


def eligible_row(eligible: torch.Tensor, s, N: int) -> torch.Tensor:
    """One service's full (N,) eligibility row."""
    if eligible.dtype == torch.bool:
        return eligible[s]
    cols = torch.arange(N, device=eligible.device)
    return eligible_lookup(eligible, s, cols)


def eligible_rows(eligible: torch.Tensor, svc: torch.Tensor,
                  N: int) -> torch.Tensor:
    """(M, N) eligibility rows for a batch of services."""
    if eligible.dtype == torch.bool:
        return eligible[svc]
    cols = torch.arange(N, device=eligible.device)
    return eligible_lookup(eligible, svc[:, None], cols[None, :])


# the tensor fields of a TorchProblem (the optional ones may be None)
TENSOR_FIELDS = ("demand", "capacity", "conflict_ids", "coloc_ids",
                 "eligible", "node_valid", "node_topology", "preferred",
                 "sticky_prev")


@dataclass
class TorchProblem:
    """The staged problem: tensors on one device plus host statics (the
    counterpart of the reference's ``DeviceProblem`` pytree)."""
    demand: torch.Tensor         # (S, R) f32
    capacity: torch.Tensor       # (N, R) f32
    conflict_ids: torch.Tensor   # (S, K) i32, -1 pad (ports ∪ volumes ∪ anti)
    coloc_ids: torch.Tensor      # (S, C) i32, -1 pad
    # packed (S, ceil(N/32)) int32 words, or dense (S, N) bool
    eligible: torch.Tensor
    node_valid: torch.Tensor     # (N,) bool
    node_topology: torch.Tensor  # (N,) i32 in [0, T)
    S: int
    N: int
    G: int                       # number of conflict ids
    Gc: int                      # number of coloc ids (0 = none)
    T: int                       # number of topology domains
    strategy: int
    max_skew: int
    # (S, N) f32 soft preference plane, or None when no service scores nodes
    preferred: Optional[torch.Tensor] = None
    # count of real (non-phantom) rows; None when every row is real. Rows
    # >= n_real carry no topology weight. A host int: PyTorch does not
    # recompile on a changed value, so nothing is gained by a device scalar.
    n_real: Optional[int] = None
    # warm-start stickiness: the previous assignment (S,) i32 and the
    # per-service bonus, folded into the proposal delta and the soft
    # ranking on the fly. The bonus is a host float: it reaches the sweep
    # kernel as a launch argument, so it never needs a device copy.
    sticky_prev: Optional[torch.Tensor] = None
    sticky_w: Optional[float] = None
    # lane-stacked problem (the tenant multiplexer, solver/multiplex.py):
    # 0 for one problem; L when every tensor above carries a leading (L,)
    # lane axis. The statics are then shared (lanes of one tier) and
    # n_real / sticky_w are per-lane tuples (every n_real set).
    lanes: int = 0

    @property
    def device(self) -> torch.device:
        return self.demand.device

    def tensors(self) -> list[Optional[torch.Tensor]]:
        """The problem's tensors, in a fixed order (None where absent)."""
        return [getattr(self, name) for name in TENSOR_FIELDS]

    def lane(self, i: int) -> "TorchProblem":
        """Lane i of a lane-stacked problem, as one problem of views."""
        if not self.lanes:
            raise ValueError("lane() of a problem that is not lane-stacked")
        views = {name: None if t is None else t[i]
                 for name, t in zip(TENSOR_FIELDS, self.tensors())}
        return dataclasses.replace(
            self, **views, lanes=0, n_real=self.n_real[i],
            sticky_w=None if self.sticky_w is None else self.sticky_w[i])

    def as_lanes(self) -> "TorchProblem":
        """One problem as a lane-stacked problem of one lane (views)."""
        if self.lanes:
            return self
        views = {name: None if t is None else t.unsqueeze(0)
                 for name, t in zip(TENSOR_FIELDS, self.tensors())}
        return dataclasses.replace(
            self, **views, lanes=1, n_real=(self.real_rows,),
            sticky_w=None if self.sticky_w is None else (self.sticky_w,))

    def lane_scalars(self) -> tuple[list[int], Optional[list[float]]]:
        """(n_real, sticky_w) of each lane; one lane for one problem."""
        if self.lanes:
            return (list(self.n_real),
                    None if self.sticky_w is None else list(self.sticky_w))
        return ([self.real_rows],
                None if self.sticky_w is None else [self.sticky_w])

    @property
    def eligible_packed(self) -> bool:
        return self.eligible.dtype != torch.bool

    @property
    def real_rows(self) -> int:
        """n_real as an int (S when every row is real)."""
        return self.S if self.n_real is None else int(self.n_real)


_M_PLANE_BYTES = REGISTRY.gauge(
    "fleet_solver_plane_bytes",
    "Device bytes of the most recent staging's dense (S, N) problem "
    "planes, by plane and layout (packed=\"true\" = bit-packed eligibility "
    "/ absent preferred plane)",
    labels=("plane", "packed"))


def record_plane_bytes(prob: TorchProblem) -> None:
    """Report the staged footprint of the (S, N) planes (the packed layout
    above), read off the staging itself."""
    e = prob.eligible
    _M_PLANE_BYTES.set(float(e.numel() * e.element_size()), plane="eligible",
                       packed="true" if prob.eligible_packed else "false")
    if prob.preferred is None:
        _M_PLANE_BYTES.set(0.0, plane="preferred", packed="true")
    else:
        p = prob.preferred
        _M_PLANE_BYTES.set(float(p.numel() * p.element_size()),
                           plane="preferred", packed="false")


def unify_conflict_ids(pt: ProblemTensors) -> np.ndarray:
    """Concatenate the three id families into one id space, compacting out
    unused slots per row (reference: problem._unify_conflict_ids)."""
    parts = []
    offset = 0
    for arr in (pt.port_ids, pt.volume_ids, pt.anti_ids):
        shifted = np.where(arr >= 0, arr + offset, -1)
        if arr.size:
            offset += int(arr.max(initial=-1)) + 1
        parts.append(shifted)
    merged = np.concatenate(parts, axis=1)
    # dedupe within each row (a repeated id on one service is one
    # constraint, not a self-conflict): sort descending, blank repeats,
    # then trim all-pad columns
    merged = -np.sort(-merged, axis=1)
    dup = np.zeros_like(merged, dtype=bool)
    dup[:, 1:] = (merged[:, 1:] == merged[:, :-1]) & (merged[:, 1:] >= 0)
    merged = np.where(dup, -1, merged)
    merged = -np.sort(-merged, axis=1)
    keep = int((merged >= 0).sum(axis=1).max(initial=1))
    return merged[:, : max(keep, 1)].astype(np.int32)


def prepare_problem(pt: ProblemTensors, device: torch.device,
                    packed: Optional[bool] = None,
                    extents: Optional[Callable[..., tuple]] = None
                    ) -> TorchProblem:
    """Stage a ProblemTensors onto `device`. `packed=None` defers to
    FLEET_PACKED (default on); `packed=False` is the dense layout.
    `extents(S, K, C, G, Gc)` returns the padded (S, K, C, G, Gc) to stage
    at, the rows and columns past the real ones filled as inert phantoms
    (solver/buckets.py); None stages the exact shapes."""
    if packed is None:
        packed = packed_enabled()
    device = torch.device(device)
    conflict = unify_conflict_ids(pt)
    S, N = pt.S, pt.N
    real = (S, conflict.shape[1], pt.coloc_ids.shape[1],
            max(int(conflict.max(initial=-1)) + 1, 1),
            int(pt.coloc_ids.max(initial=-1)) + 1)
    S_pad, K_pad, C_pad, G, Gc = real if extents is None else extents(*real)

    def put(arr, dtype, cols=None, fill=None):
        # torch.tensor always copies: a CPU staging must not alias the
        # caller's numpy arrays, which the resident merge updates in place
        if cols is not None and (S_pad, cols) != arr.shape:
            out = np.full((S_pad, cols), fill, dtype=arr.dtype)
            out[:S, : arr.shape[1]] = arr
            arr = out
        return torch.tensor(np.ascontiguousarray(arr), dtype=dtype,
                            device=device)

    if pt.preferred is None:
        preferred = (None if packed else
                     torch.zeros((S_pad, N), dtype=torch.float32,
                                 device=device))
    else:
        preferred = put(pt.preferred, torch.float32, N, 0.0)
    if packed:
        eligible = put(pack_bool_rows(pt.eligible), torch.int32,
                       packed_width(N), -1)
    else:
        eligible = put(pt.eligible, torch.bool, N, True)
    prob = TorchProblem(
        demand=put(pt.demand, torch.float32, pt.demand.shape[1], 0.0),
        capacity=put(pt.capacity, torch.float32),
        conflict_ids=put(conflict, torch.int32, K_pad, -1),
        coloc_ids=put(pt.coloc_ids, torch.int32, C_pad, -1),
        eligible=eligible,
        node_valid=put(pt.node_valid, torch.bool),
        node_topology=put(pt.node_topology, torch.int32),
        preferred=preferred,
        S=S_pad, N=N, G=G, Gc=Gc,
        T=int(pt.node_topology.max(initial=0)) + 1,
        strategy=STRATEGY_CODES[PlacementStrategy(pt.strategy)],
        max_skew=int(pt.max_skew),
    )
    record_plane_bytes(prob)
    return prob
