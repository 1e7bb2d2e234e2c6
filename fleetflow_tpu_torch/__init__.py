"""fleetflow_tpu_torch: the placement solver of fleetflow on PyTorch and CUDA.

A port of ``fleetflow_tpu``'s device path (bucketed staging with phantom
rows, batched greedy seed, parallel-Metropolis anneal, fused churn
pre-repair, exact violation gate, resident warm reschedules with the
churn-localized sub-solve, the slot manager and the tenant multiplexer) to
one NVIDIA Hopper card. The five kernels that
carry the hot path are hand-written CUDA C++ under ``csrc/``; every other
device step is plain PyTorch. The package imports neither JAX nor
``fleetflow_tpu``: what it needs of the host layers it keeps as its own copy
(``core/``, ``lower/``, ``solver/repair.py``, ``sched/base.py``).

The front end (``core/``: the KDL parser with its native fast path, the
flow parser, templates, discovery, the parse cache and the loader;
``lower/``: ``lower_stage`` and the fleet generator) turns a project's KDL
text into ``ProblemTensors`` and imports no torch.

Entry points (``sched.gpu.GpuSolverScheduler`` with ``place_many``,
``solver.api.solve``, ``solver.multiplex.solve_multiplexed``) run on the
card unless the caller passes ``device="cpu"``; they never fall back.
"""

__version__ = "0.1.0"

__all__ = ["resolve_device"]


def __getattr__(name):
    # resolve_device is imported on first use: the config front end
    # (core/, lower/, native/) is usable without importing torch
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
