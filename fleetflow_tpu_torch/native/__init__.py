"""The host placer (``csrc/host/placer.cpp``) through ctypes: the native
first-fit-decreasing seed and its scheduler. The library is built with g++
at first use; when it cannot be built, the callers raise SolverError (no
fallback to another placer)."""

from .lib import native_place
from .sched import NativeGreedyScheduler

__all__ = ["native_place", "NativeGreedyScheduler"]
