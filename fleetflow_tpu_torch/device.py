"""Device selection without fallback.

The port's entry points run on the card. ``resolve_device()`` returns the
CUDA device and raises when CUDA is absent; the CPU is used only when a
caller asks for it by name (the parity tests do), never as a silent
substitute for a missing card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .core.errors import DeviceUnavailable, SolverError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a solve runs on: CUDA unless `device` names the CPU.
    Raises DeviceUnavailable (a SolverError) when CUDA is asked for
    (explicitly or by default) and the process has no usable card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "fleetflow_tpu_torch needs a CUDA device; pass device='cpu' "
                "to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise SolverError(f"unsupported device {dev}")
    return dev
