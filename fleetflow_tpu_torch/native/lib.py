"""ctypes binding of the host placer's ``ff_place`` and its array
marshalling (the counterpart of ``fleetflow_tpu/native/lib.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _ext
from ..core.errors import SolverError

__all__ = ["load", "native_place"]

_LIB = "ffplacer"
_STRATEGY_CODE = {"spread_across_pool": 0, "pack_into_dedicated": 1,
                  "fill_lowest": 2}


def load() -> ctypes.CDLL:
    """The host placer, built with g++ at its first use. Raises
    SolverError when it cannot be built or loaded."""
    try:
        lib = _ext.host_library(_LIB)
    except RuntimeError as e:
        raise SolverError(f"the host placer is not available: {e}") from e
    if lib.ff_place.restype is not ctypes.c_int64:
        lib.ff_place.restype = ctypes.c_int64
        lib.ff_place.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_place(demand: np.ndarray, capacity: np.ndarray,
                 eligible: np.ndarray, node_valid: np.ndarray,
                 dep_depth: np.ndarray,
                 port_ids: np.ndarray, volume_ids: np.ndarray,
                 anti_ids: np.ndarray,
                 strategy: str = "spread_across_pool"
                 ) -> tuple[np.ndarray, int]:
    """(assignment (S,) int32, violations) of the host FFD. Raises
    SolverError when the library cannot be built."""
    S, R = demand.shape
    N = capacity.shape[0]
    want = {"capacity": (capacity, (N, R)), "eligible": (eligible, (S, N)),
            "node_valid": (node_valid, (N,)), "dep_depth": (dep_depth, (S,))}
    for name, (arr, shape) in want.items():
        if np.shape(arr) != shape:
            raise ValueError(f"{name} has shape {np.shape(arr)}, expected "
                             f"{shape}")
    for name, ids in (("port_ids", port_ids), ("volume_ids", volume_ids),
                      ("anti_ids", anti_ids)):
        if np.ndim(ids) != 2 or np.shape(ids)[0] != S:
            raise ValueError(f"{name} has shape {np.shape(ids)}, expected "
                             f"({S}, k)")
    lib = load()
    demand = np.ascontiguousarray(demand, dtype=np.float64)
    capacity = np.ascontiguousarray(capacity, dtype=np.float64)
    eligible = np.ascontiguousarray(eligible, dtype=np.uint8)
    node_valid = np.ascontiguousarray(node_valid, dtype=np.uint8)
    dep_depth = np.ascontiguousarray(dep_depth, dtype=np.int32)
    port_ids = np.ascontiguousarray(port_ids, dtype=np.int32)
    volume_ids = np.ascontiguousarray(volume_ids, dtype=np.int32)
    anti_ids = np.ascontiguousarray(anti_ids, dtype=np.int32)
    out = np.zeros(S, dtype=np.int32)
    violations = lib.ff_place(
        S, N, R,
        _ptr(demand, ctypes.c_double), _ptr(capacity, ctypes.c_double),
        _ptr(eligible, ctypes.c_uint8), _ptr(node_valid, ctypes.c_uint8),
        _ptr(dep_depth, ctypes.c_int32),
        _ptr(port_ids, ctypes.c_int32), port_ids.shape[1],
        _ptr(volume_ids, ctypes.c_int32), volume_ids.shape[1],
        _ptr(anti_ids, ctypes.c_int32), anti_ids.shape[1],
        _STRATEGY_CODE[strategy],
        _ptr(out, ctypes.c_int32))
    return out, int(violations)
