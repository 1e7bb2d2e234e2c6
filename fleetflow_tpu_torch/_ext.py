"""Build, load and count the hand-written CUDA kernels and the host libraries.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``; the libraries are loaded with
``ctypes``. Nothing here touches the compiler or the card at import time:
the first wrapper call on a CUDA tensor builds every source at once (one
``nvcc`` process per file, all started together) into ``_ext_build/``, a
directory named after a hash of the sources and flags so a changed source
never loads a stale library.

The host libraries are plain C++: the host placer (``csrc/host/placer.cpp``,
the native first-fit-decreasing seed and the Kahn dependency depths), the
native KDL parser (``csrc/host/kdl.cpp``, a ctypes library) and its CPython
assembly (``csrc/host/kdlpy.cpp`` with ``kdl.cpp``, an extension module
compiled against this interpreter's headers and named with its
``EXT_SUFFIX``). ``g++`` builds each at its first use (:func:`host_library`,
:func:`host_extension`; no card, no ``nvcc``, no torch) into a hashed
directory of its own, so an edit to one rebuilds none of the kernels and a
failed host build stops no kernel from loading. A failed build raises with
the compiler's output, as for the CUDA sources.

Every failure of this layer (a missing compiler, a failed build or load,
a CUDA error after a launch) raises ``KernelError``, a ``RuntimeError``:
the control plane's degrade path re-raises it rather than place on the
host around a broken kernel.

K1-K3 take a lane axis (the tenant multiplexer): L same-tier problems
stacked on a leading axis, with the per-lane scalars in one by-value
:class:`Lanes` struct (``FFLanes`` in ``csrc/common.cuh``); a solo call is
L = 1. K7 (the sharded sweep) takes its per-replica temperatures in the
same struct. K1 and K7 share the move delta (``csrc/sweep_delta.cuh``);
K3 and K5 list a node's rows and sum their demand in row order
(``csrc/node_rows.cuh``).

Every C entry point returns a ``cudaError_t`` (0 = success) taken from
``cudaGetLastError()`` right after its launches; :func:`check` raises on
anything else. ``LAUNCHES`` counts the entry-point calls per kernel: a
wrapper adds one where it launches its kernel and nowhere else, so a run can
show which kernels the main path went through. A process started with
``FLEET_LAUNCH_DIR`` set writes its counts to
``$FLEET_LAUNCH_DIR/launches-<pid>.json`` when it exits, so a driver can read
those of a CLI, MCP or daemon process it started.

``fleet_solver_compile_events_total`` (the reference's name) counts the
port's only compiles: each kernel library and host library this process
built or loaded, at its first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Optional

from .core.errors import KernelError
from .obs.metrics import REGISTRY

if TYPE_CHECKING:
    import torch

__all__ = ["KERNELS", "HOST_LIBS", "HOST_EXTS", "LAUNCHES", "MAX_LANES", "Lanes",
           "ProblemArgs", "SweepArgs", "K7Args", "lanes_arg", "build",
           "library", "host_library", "host_extension", "launch", "raise_on", "raise_error",
           "reset_launches", "check_inputs", "M_COMPILE_EVENTS"]

M_COMPILE_EVENTS = REGISTRY.counter(
    "fleet_solver_compile_events_total",
    "Kernel-library builds or loads (the CUDA kernels' and the host "
    "placer's shared libraries, at their first use in the process)")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent / "_ext_build"

# kernel name -> CUDA source (one shared library each)
KERNELS = {
    "k1_sweep": "k1_sweep.cu",
    "k2_prerepair": "k2_prerepair.cu",
    "k3_rebuild": "k3_rebuild.cu",
    "k4_greedy": "k4_greedy.cu",
    "k5_subsolve": "k5_subsolve.cu",
    "k6_greedy_scan": "k6_greedy_scan.cu",
    "k7_sharded_sweep": "k7_sharded_sweep.cu",
}
_HEADERS = ("common.cuh", "sweep_delta.cuh", "node_rows.cuh")
# host library name -> C++ sources (plain C ABI, built with g++)
HOST_LIBS = {
    "ffplacer": ("host/placer.cpp",),
    "ffkdl": ("host/kdl.cpp",),
}
# CPython extension name -> C++ sources (built with g++ against this
# interpreter's Python.h; CPython resolves its symbols at import time)
HOST_EXTS = {
    "ffkdlpy": ("host/kdlpy.cpp", "host/kdl.cpp"),
}
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

# the lane ladder's cap (solver/multiplex.py): FF_MAX_LANES in common.cuh
MAX_LANES = 16


class Lanes(ctypes.Structure):
    """The per-lane scalars of a lane-aware launch, passed BY VALUE (a
    device array would be a host-to-device copy inside the warm
    dispatch): K1's temperature, the stickiness bonus, the real-row count
    and K1's active flag of each lane."""
    _fields_ = [("temp", ctypes.c_float * MAX_LANES),
                ("sticky_w", ctypes.c_float * MAX_LANES),
                ("n_real", ctypes.c_int * MAX_LANES),
                ("active", ctypes.c_int * MAX_LANES)]


class ProblemArgs(ctypes.Structure):
    """``Problem`` of ``csrc/sweep_delta.cuh``: one staged problem's sizes,
    planes (device pointers; 0 for an absent optional plane) and
    statics."""
    _fields_ = [("S", ctypes.c_int), ("N", ctypes.c_int),
                ("G", ctypes.c_int), ("Gc1", ctypes.c_int),
                ("T", ctypes.c_int), ("K", ctypes.c_int),
                ("Kc", ctypes.c_int), ("demand", ctypes.c_void_p),
                ("cap", ctypes.c_void_p), ("cids", ctypes.c_void_p),
                ("colids", ctypes.c_void_p), ("elig", ctypes.c_void_p),
                ("packed", ctypes.c_int), ("stride", ctypes.c_int),
                ("valid", ctypes.c_void_p), ("ntopo", ctypes.c_void_p),
                ("pref", ctypes.c_void_p), ("sticky_prev", ctypes.c_void_p),
                ("sticky_w", ctypes.c_float), ("strategy", ctypes.c_int),
                ("max_skew", ctypes.c_int), ("n_real", ctypes.c_int)]


class SweepArgs(ctypes.Structure):
    """``K1Static`` of ``csrc/k1_sweep.cu``: what stays fixed over an
    anneal call's sweeps (the problem, the lane and chain counts, the
    proposals a chain and the state planes), passed by pointer."""
    _fields_ = [("p", ProblemArgs), ("L", ctypes.c_int),
                ("C", ctypes.c_int), ("M", ctypes.c_int),
                ("assignment", ctypes.c_void_p), ("load", ctypes.c_void_p),
                ("used", ctypes.c_void_p), ("coloc", ctypes.c_void_p),
                ("topo", ctypes.c_void_p)]


class K7Args(ctypes.Structure):
    """``K7Static`` of ``csrc/k7_sharded_sweep.cu``: what stays fixed over
    an anneal call's sharded sweeps (the problem, the replica and shard
    counts, the proposals a position, the state planes and the scratch),
    and the launch shape ``ff_k7_bind`` fills; passed by pointer."""
    _fields_ = [("p", ProblemArgs), ("R", ctypes.c_int),
                ("D", ctypes.c_int), ("M", ctypes.c_int),
                ("assignment", ctypes.c_void_p), ("load", ctypes.c_void_p),
                ("used", ctypes.c_void_p), ("coloc", ctypes.c_void_p),
                ("topo", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
                ("partial", ctypes.c_void_p), ("grid", ctypes.c_int),
                ("threads", ctypes.c_int), ("H", ctypes.c_int),
                ("smem", ctypes.c_longlong)]


def lanes_arg(n_real, sticky_w=None, temp=None, active=None) -> Lanes:
    """A :class:`Lanes` of len(n_real) lanes; the unset fields of a lane
    are 0 (active: 1)."""
    L = len(n_real)
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"{L} lanes: the kernels take 1 to {MAX_LANES}")
    out = Lanes()
    for i in range(L):
        out.n_real[i] = int(n_real[i])
        out.sticky_w[i] = 0.0 if sticky_w is None else float(sticky_w[i])
        out.temp[i] = 0.0 if temp is None else float(temp[i])
        out.active[i] = 1 if active is None else int(bool(active[i]))
    return out


_lock = threading.Lock()
_host_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_host_libs: dict[str, ctypes.CDLL] = {}
_host_exts: dict = {}
_torch = None                           # see _torch_module


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _write_launches(directory: str) -> None:
    """At exit: this process's launch counts as JSON (FLEET_LAUNCH_DIR)."""
    import json
    import sys
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"launches-{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"pid": os.getpid(), "argv": sys.argv[1:],
                   "launches": dict(LAUNCHES)}, f)
    os.replace(path + ".tmp", path)


if os.environ.get("FLEET_LAUNCH_DIR"):
    import atexit
    atexit.register(_write_launches, os.environ["FLEET_LAUNCH_DIR"])


def check_inputs(name: str, *tensors: Optional[torch.Tensor],
                 lanes: Optional[int] = None) -> None:
    """The wrapper contract: a CUDA tensor launches the kernel or raises.
    Every tensor lies on one device and is contiguous (a lane's stride is
    its per-lane size); with `lanes`, every one is stacked on a leading
    axis of that extent. None (an absent optional plane) is skipped."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor {tuple(t.shape)}")
        if lanes is not None and (t.dim() == 0 or t.shape[0] != lanes):
            raise ValueError(f"{name}: tensor {tuple(t.shape)} is not "
                             f"stacked on {lanes} lanes")


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise KernelError("g++ not found: the host libraries need a C++ "
                           "compiler (set CXX)")
    return found


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(set(sources)):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _kernel_dir() -> Path:
    return _BUILD_ROOT / _digest([*KERNELS.values(), *_HEADERS], NVCC_FLAGS)


def _host_dir() -> Path:
    sources = [src for srcs in (*HOST_LIBS.values(), *HOST_EXTS.values())
               for src in srcs]
    return _BUILD_ROOT / ("host-" + _digest(sources, CXX_FLAGS))


def _compile(jobs: dict, out_dir: Path, verbose: bool) -> None:
    """Run every job's compiler at once; `jobs` maps a library's file name
    to its command without the output path. Each builds to a temporary
    file that is renamed into place, so concurrent builds never load half
    a library. Raises with the compilers' output when any fails."""
    procs = {}
    for name, cmd in jobs.items():
        target = out_dir / name
        if target.exists():
            continue
        tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {name} ---\n{log}")
            continue
        if verbose and log:
            print(f"[build {name}]\n{log}", flush=True)
        os.replace(tmp, target)
    if errors:
        raise KernelError("build failed:\n" + "\n".join(errors))


def build(verbose: bool = False) -> float:
    """Compile every kernel source (in parallel) and load the libraries;
    returns the seconds it took (0 when already loaded). Raises with the
    compiler's output when a source does not build."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return 0.0
        t0 = time.perf_counter()
        out_dir = _kernel_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = {}
        for name, src in KERNELS.items():
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), str(_CSRC / src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs[f"lib{name}.so"] = cmd
        _compile(jobs, out_dir, verbose)
        for name in KERNELS:
            try:
                lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            except OSError as e:
                raise KernelError(f"kernel library {name}: {e}") from e
            lib.ff_error_string.argtypes = [ctypes.c_int]
            lib.ff_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        M_COMPILE_EVENTS.inc(len(KERNELS))
        return time.perf_counter() - t0


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name`, built with g++ at its first use (no
    card, no nvcc). Raises KernelError when it cannot be built or
    loaded."""
    lib = _host_libs.get(name)
    if lib is not None:
        return lib
    with _host_lock:
        if name not in _host_libs:
            out_dir = _host_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            if not (out_dir / f"lib{name}.so").exists():
                _compile({f"lib{name}.so": [
                    _cxx(), *CXX_FLAGS,
                    *(str(_CSRC / src) for src in HOST_LIBS[name])]},
                    out_dir, verbose=False)
            try:
                _host_libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            except OSError as e:
                raise KernelError(f"host library {name}: {e}") from e
            M_COMPILE_EVENTS.inc()
        return _host_libs[name]


def _python_include() -> str:
    inc = sysconfig.get_paths().get("include") or ""
    if not (Path(inc) / "Python.h").is_file():
        raise KernelError(
            f"Python.h not found in {inc!r}: the CPython extensions need "
            f"this interpreter's development headers")
    return inc


def host_extension(name: str):
    """The imported CPython extension `name`, built with g++ against this
    interpreter's headers at its first use (the file carries the
    interpreter's EXT_SUFFIX, so another interpreter never imports it).
    Raises KernelError when it cannot be built or imported."""
    mod = _host_exts.get(name)
    if mod is not None:
        return mod
    with _host_lock:
        if name not in _host_exts:
            out_dir = _host_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            fname = name + (sysconfig.get_config_var("EXT_SUFFIX") or ".so")
            if not (out_dir / fname).exists():
                _compile({fname: [
                    _cxx(), *CXX_FLAGS, "-I", _python_include(),
                    *(str(_CSRC / src) for src in HOST_EXTS[name])]},
                    out_dir, verbose=False)
            spec = importlib.util.spec_from_file_location(
                name, str(out_dir / fname))
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except (ImportError, OSError) as e:
                raise KernelError(f"host extension {name}: {e}") from e
            _host_exts[name] = mod
            M_COMPILE_EVENTS.inc()
        return _host_exts[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first use."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
    return lib


def _torch_module():
    """torch, imported at the first kernel launch: the host libraries (and
    the front end that loads them) need no torch."""
    global _torch
    if _torch is None:
        import torch
        _torch = torch
    return _torch


def _c_arg(a):
    if isinstance(a, (_torch or _torch_module()).Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if a is None:                       # absent optional plane
        return ctypes.c_void_p(0)
    if isinstance(a, (bool, int)):
        if not -2**31 <= int(a) < 2**31:
            raise ValueError(f"int argument {a} does not fit a C int")
        return ctypes.c_int(int(a))
    if isinstance(a, float):
        return ctypes.c_float(a)
    if isinstance(a, Lanes):            # by value
        return a
    raise TypeError(f"unsupported kernel argument {type(a).__name__}")


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point `fn` of kernel `name` on `device`'s current
    stream, raise on the CUDA error it returns, and count the launch.
    Tensors pass as device pointers, None as a null pointer, ints as C
    ints, floats as C floats and a :class:`Lanes` by value; the stream is
    appended last."""
    torch = _torch or _torch_module()
    c_args = [_c_arg(a) for a in args]
    c_args.append(ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    raise_on(name, getattr(library(name), fn)(*c_args))


def raise_error(name: str, err: int) -> None:
    """Raise on the CUDA error a C entry point of kernel `name` returned."""
    if err != 0:
        msg = library(name).ff_error_string(err).decode()
        raise KernelError(f"{name}: CUDA error {err}: {msg}")


def raise_on(name: str, err: int) -> None:
    """Raise on the CUDA error a C entry point of kernel `name` returned;
    else count its launch."""
    raise_error(name, err)
    LAUNCHES[name] += 1
