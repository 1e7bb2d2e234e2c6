"""The host libraries through ctypes: the host placer
(``csrc/host/placer.cpp``: the native first-fit-decreasing seed, its
scheduler and the Kahn dependency depths) and the native KDL parser
(``csrc/host/kdl.cpp``, with its CPython assembly ``csrc/host/kdlpy.cpp``).
Each library is built with g++ at first use; when one cannot be built, the
caller raises (no fallback to another placer, no quiet switch to the
Python parser)."""

from .lib import native_dep_depths, native_place

__all__ = ["native_place", "native_dep_depths", "NativeGreedyScheduler"]


def __getattr__(name):
    # the scheduler pulls in the scheduler layer (and torch) on first use:
    # the KDL front end imports this package without them
    if name == "NativeGreedyScheduler":
        from .sched import NativeGreedyScheduler
        return NativeGreedyScheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
