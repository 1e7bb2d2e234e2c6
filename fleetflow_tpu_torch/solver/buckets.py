"""Shape buckets and phantom rows (port of ``solver/buckets.py``).

The reference rounds the churn-sensitive extents of a staged problem up to a
tier ladder so that every fleet size inside a tier reuses one compiled XLA
program. PyTorch does not compile per shape, but the port keeps the same
padded staging because the warm path rests on it: a fleet that grows inside
its tier takes its arrivals as row scatters into PHANTOM rows of the
resident problem (``resident.ProblemDelta.n_real``), with no restaging.

  S   (service rows)        -> next tier (x``growth`` steps from ``minimum``)
  K   (conflict-id columns) -> next multiple of ``width_multiple``
  C   (coloc-id columns)    -> next multiple of ``width_multiple``
  G   (conflict-id count)   -> next power-of-two tier from 16
  Gc  (coloc-id count)      -> next power-of-two tier from 4

N is not bucketed. A phantom row has zero demand, no conflict or coloc ids,
no preference (an absent plane stays absent, a present one pads with
zeros) and is eligible everywhere (packed words all ones, -1 as int32;
the pad bits past N are never read as nodes). Parked on a VALID node it
touches no constraint and no score; rows >= ``n_real`` carry no topology
weight in the kernels, so spread constraints stay exact. Solves report the
soft score of the real rows (``repair.soft_score_host``), because the padded
problem's mean denominators count phantoms.

Config: ``bucket_config()`` reads FLEET_BUCKET (0 disables),
FLEET_BUCKET_GROWTH (default 1.25) and FLEET_BUCKET_MIN (default 64), the
reference's names.

The reference assembles padded host planes in per-tier arenas reused
across restagings; :func:`stage_problem_tiers` here builds fresh host
arrays for each staging and uploads each plane once (no arena cache).

:func:`record_bucket` keeps the reference's census of the padded dispatch
shapes a process has run (``fleet_solver_bucket_solves_total{hit}``): the
same extents and statics the reference keys its executables on, so both
packages count the same hits for the same sequence of solves.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..lower.tensors import ProblemTensors
from .problem import TorchProblem, prepare_problem

__all__ = ["BucketConfig", "BucketInfo", "bucket_config", "bucket_size",
           "bucket_bounds", "subsolve_tier", "width_bucket", "pad_problem",
           "pad_problem_tiers", "pad_assignment", "stage_problem_tiers",
           "record_bucket"]


@dataclass(frozen=True)
class BucketConfig:
    enabled: bool = True
    growth: float = 1.25     # geometric tier ratio for S
    minimum: int = 64        # first S tier
    width_multiple: int = 4  # K / C column rounding
    align: int = 8           # every S tier is a multiple of this


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


def bucket_config(default_enabled: bool = True) -> BucketConfig:
    """The bucketing knobs, read from the environment on each call."""
    try:
        growth = float(os.environ.get("FLEET_BUCKET_GROWTH", "1.25"))
    except ValueError:
        growth = 1.25
    try:
        minimum = int(os.environ.get("FLEET_BUCKET_MIN", "64"))
    except ValueError:
        minimum = 64
    return BucketConfig(enabled=_env_flag("FLEET_BUCKET", default_enabled),
                        growth=max(growth, 1.01), minimum=max(minimum, 8))


def bucket_size(n: int, *, growth: float = 1.25, minimum: int = 64,
                align: int = 8) -> int:
    """Smallest tier >= n on the ladder minimum, minimum*growth, ... with
    every tier rounded up to a multiple of `align`. Idempotent:
    bucket_size(bucket_size(n)) == bucket_size(n)."""
    if n <= 0:
        return align
    tier = float(minimum)
    out = -((-minimum) // align) * align
    while out < n:
        tier *= growth
        out = -((-math.ceil(tier)) // align) * align
    return out


def bucket_bounds(n: int, *, growth: float = 1.25, minimum: int = 64,
                  align: int = 8) -> tuple[int, int]:
    """(previous tier, tier) around n (0 below the ladder)."""
    upper = bucket_size(n, growth=growth, minimum=minimum, align=align)
    lower = 0
    tier = float(minimum)
    out = -((-minimum) // align) * align
    while out < upper:
        lower = out
        tier *= growth
        out = -((-math.ceil(tier)) // align) * align
    return lower, upper


def subsolve_tier(k: int, *, minimum: int = 256, maximum: int = 4096) -> int:
    """Mini tier of an active-set sub-problem of k rows: the power-of-two
    ladder minimum, 2*minimum, ... capped at `maximum`; 0 when k exceeds
    it (the closure is too big to localize)."""
    if k <= 0:
        return minimum
    tier = minimum
    while tier < k:
        tier *= 2
    return tier if tier <= maximum else 0


def width_bucket(k: int, multiple: int = 4) -> int:
    """Id-table column widths round up to a small multiple."""
    k = max(k, 1)
    return -((-k) // multiple) * multiple


@dataclass
class BucketInfo:
    """What padding a solve ran with (``SolveResult.bucket``)."""
    orig_S: int
    padded_S: int
    G: int
    Gc: int
    # this process already ran a dispatch at these padded extents
    # (record_bucket)
    hit: bool = False

    @property
    def pad_waste(self) -> float:
        """Fraction of service rows that are phantoms."""
        return 1.0 - self.orig_S / self.padded_S if self.padded_S else 0.0

    def to_dict(self) -> dict:
        return {"orig_S": self.orig_S, "padded_S": self.padded_S,
                "pad_waste": round(self.pad_waste, 4)}


def _tiers(S: int, K: int, C: int, G: int, Gc: int,
           cfg: BucketConfig) -> tuple[int, int, int, int, int]:
    """(S_pad, K_pad, C_pad, G_pad, Gc_pad) of a problem under `cfg`."""
    return (bucket_size(S, growth=cfg.growth, minimum=cfg.minimum,
                        align=cfg.align),
            width_bucket(K, cfg.width_multiple),
            width_bucket(C, cfg.width_multiple),
            bucket_size(G, growth=2.0, minimum=16, align=4),
            bucket_size(Gc, growth=2.0, minimum=4, align=2) if Gc > 0 else 0)


def _elig_fill(eligible: torch.Tensor):
    """Phantom fill of the eligibility plane: all bits set (-1) for packed
    int32 words, True for the dense bool layout."""
    return True if eligible.dtype == torch.bool else -1


def _pad(t: torch.Tensor, rows: int, cols: int, fill) -> torch.Tensor:
    """`t` grown by `rows` rows and `cols` columns of `fill` (a copy)."""
    if not rows and not cols:
        return t
    out = t.new_full((t.shape[0] + rows, t.shape[1] + cols), fill)
    out[: t.shape[0], : t.shape[1]].copy_(t)
    return out


def _with_phantoms(prob: TorchProblem, pad: int, dK: int = 0, dC: int = 0,
                   **statics) -> TorchProblem:
    """`prob` grown by `pad` phantom rows (and dK/dC empty id columns)."""
    kw = {}
    if prob.preferred is not None:      # an absent plane stays absent
        kw["preferred"] = _pad(prob.preferred, pad, 0, 0.0)
    return dataclasses.replace(
        prob, demand=_pad(prob.demand, pad, 0, 0.0),
        conflict_ids=_pad(prob.conflict_ids, pad, dK, -1),
        coloc_ids=_pad(prob.coloc_ids, pad, dC, -1),
        eligible=_pad(prob.eligible, pad, 0, _elig_fill(prob.eligible)),
        **kw, **statics)


def pad_problem(prob: TorchProblem, multiple: int
                ) -> tuple[TorchProblem, int]:
    """Pad the service axis to a multiple of `multiple` with phantom rows.
    Returns (padded problem, original S); slice results back to [:S]."""
    pad = (-prob.S) % multiple
    if pad == 0:
        return prob, prob.S
    return _with_phantoms(prob, pad, S=prob.S + pad), prob.S


def pad_problem_tiers(prob: TorchProblem,
                      cfg: Optional[BucketConfig] = None
                      ) -> tuple[TorchProblem, BucketInfo]:
    """Round a staged problem up to its bucket (S, K, C, G, Gc). Returns
    (padded problem, BucketInfo); a problem already on its tiers comes back
    as the same object. A set n_real is kept; otherwise it becomes the
    original S."""
    cfg = cfg or bucket_config()
    K, C = prob.conflict_ids.shape[1], prob.coloc_ids.shape[1]
    S_pad, K_pad, C_pad, G_pad, Gc_pad = _tiers(prob.S, K, C, prob.G,
                                                prob.Gc, cfg)
    info = BucketInfo(orig_S=prob.S, padded_S=S_pad, G=G_pad, Gc=Gc_pad)
    if (S_pad, K_pad, C_pad, G_pad, Gc_pad) == (prob.S, K, C, prob.G,
                                                prob.Gc):
        return prob, info
    return _with_phantoms(
        prob, S_pad - prob.S, K_pad - K, C_pad - C, S=S_pad, G=G_pad,
        Gc=Gc_pad,
        n_real=prob.S if prob.n_real is None else prob.n_real), info


def pad_assignment(assignment: np.ndarray, padded_S: int,
                   node_valid: np.ndarray) -> np.ndarray:
    """Extend a real-row assignment with phantom placements on the first
    VALID node (a phantom on an invalid node counts as an eligibility
    violation)."""
    assignment = np.asarray(assignment, dtype=np.int32)
    pad = padded_S - assignment.shape[0]
    if pad <= 0:
        return assignment
    valid = np.flatnonzero(node_valid)
    fill = int(valid[0]) if valid.size else 0
    return np.concatenate([assignment, np.full(pad, fill, dtype=np.int32)])


def stage_problem_tiers(pt: ProblemTensors,
                        cfg: Optional[BucketConfig] = None,
                        device=None, packed: Optional[bool] = None
                        ) -> tuple[TorchProblem, BucketInfo]:
    """Stage a ProblemTensors directly at its padded bucket shape: the
    padded planes are built on the host and each is uploaded once. Equal to
    ``pad_problem_tiers(prepare_problem(pt), cfg)``, bit for bit; n_real is
    the real row count when any extent padded, else None (the reference's
    statics). The planes land on the card unless `device` names the CPU
    (raises without CUDA, as solve does); `packed=None` defers to
    FLEET_PACKED."""
    cfg = cfg or bucket_config()
    real: tuple = ()

    def extents(*shape):
        nonlocal real
        real = shape
        return _tiers(*shape, cfg) if cfg.enabled else shape

    prob = prepare_problem(pt, resolve_device(device), packed, extents)
    if (prob.S, prob.conflict_ids.shape[1], prob.coloc_ids.shape[1],
            prob.G, prob.Gc) != real:
        prob.n_real = pt.S
    return prob, BucketInfo(orig_S=pt.S, padded_S=prob.S, G=prob.G,
                            Gc=prob.Gc)


_seen_buckets: set = set()
_seen_lock = threading.Lock()


def record_bucket(key: tuple) -> bool:
    """Record a padded dispatch key; True when it was already seen (hit)."""
    with _seen_lock:
        hit = key in _seen_buckets
        _seen_buckets.add(key)
        return hit
