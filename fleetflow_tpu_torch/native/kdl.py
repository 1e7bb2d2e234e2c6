"""Native KDL parse: ctypes binding over ``csrc/host/kdl.cpp`` (the port's
copy of ``fleetflow_tpu/native/kdl.py``).

``native_parse_document(text)`` returns the same list[KdlNode] as the pure
Python parser (core/kdl.py), several times faster on fleet-scale
documents, or None when the document needs Python semantics: it exercises
an unsupported corner (int64-overflowing literals), a known unicode
classification divergence is possible (``_unicode_divergence_risk``), or
the native parse errored. On None the caller parses in Python, so the
error path raises the canonical KdlError with codepoint-exact line/col;
core/kdl.py:parse_document does exactly this.

The libraries are built with g++ at their first use (``_ext.host_library``
and ``_ext.host_extension``): a library that cannot be built raises
RuntimeError with the compiler's output instead of quietly handing every
parse to Python. The tree is assembled by the CPython extension
(``csrc/host/kdlpy.cpp``) unless ``FLEET_KDL_ASSEMBLY=ctypes`` asks for the
ctypes-array loop below (the parity suite runs both).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .. import _ext

__all__ = ["native_parse_document", "kdl_native_available", "assembly"]

_LIB = "ffkdl"
_EXT = "ffkdlpy"

# The CDLL instance whose symbols were configured, compared with `is`.
_configured_lib = None


def load() -> ctypes.CDLL:
    """The native KDL library with its symbols configured, built at its
    first use. Raises RuntimeError when it cannot be built or loaded."""
    global _configured_lib
    lib = _ext.host_library(_LIB)
    if _configured_lib is lib:
        return lib
    lib.ff_kdl_parse.restype = ctypes.c_void_p
    lib.ff_kdl_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ff_kdl_counts.restype = None
    lib.ff_kdl_counts.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 3
    lib.ff_kdl_export.restype = None
    lib.ff_kdl_export.argtypes = [
        ctypes.c_void_p,
        *([ctypes.POINTER(ctypes.c_int32)] * 8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        *([ctypes.POINTER(ctypes.c_int32)] * 4),
        ctypes.c_char_p,
    ]
    lib.ff_kdl_free.restype = None
    lib.ff_kdl_free.argtypes = [ctypes.c_void_p]
    _configured_lib = lib
    return lib


def kdl_native_available() -> bool:
    """True once the native parser (and, unless FLEET_KDL_ASSEMBLY=ctypes,
    its CPython assembly) is built and loaded. Raises RuntimeError when a
    library cannot be built: there is no quiet fallback."""
    load()
    _load_ext()
    return True


def assembly() -> str:
    """Which assembly serves a native parse: "extension" (the CPython
    module) or "ctypes" (FLEET_KDL_ASSEMBLY=ctypes)."""
    return "ctypes" if _ctypes_forced() else "extension"


def _ctypes_forced() -> bool:
    return os.environ.get("FLEET_KDL_ASSEMBLY", "").lower() in ("ctypes",
                                                                "py")


def _load_ext():
    """The CPython assembly module, or None when FLEET_KDL_ASSEMBLY=ctypes
    forces the ctypes loop. Built against this interpreter's headers and
    tagged with its EXT_SUFFIX; raises RuntimeError when it cannot be
    built."""
    if _ctypes_forced():
        return None
    return _ext.host_extension(_EXT)


def _unicode_divergence_risk(text: str) -> bool:
    """True when the document could hit a known native/Python classification
    divergence, so the caller must take the Python path.

    The C++ parser classifies value-starts with ASCII-only isdigit/isalpha
    (kdl.cpp documented divergence); Python's checks are unicode-aware. Two
    inputs flip between "value" and "bare identifier" across the parsers:
      - a non-ASCII unicode digit anywhere (`a ٣`: Python enters
        parse_number and raises; C++ accepts a bare-word arg)
      - '#' immediately followed by a non-ASCII alpha (`a #é`: Python
        enters keyword parsing and raises; C++ accepts a bare word)
    Conservative by design: a '#é' inside a quoted string also triggers the
    fallback — merely slower, never wrong.
    """
    for ch in set(text):
        if not ch.isascii() and ch.isdigit():
            return True
    idx = text.find("#")
    while idx != -1 and idx + 1 < len(text):
        nxt = text[idx + 1]
        if not nxt.isascii() and nxt.isalpha():
            return True
        idx = text.find("#", idx + 1)
    return False


def _i32(n: int) -> np.ndarray:
    return np.zeros(max(n, 1), dtype=np.int32)


def _pt(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def native_parse_document(text: str) -> Optional[list]:
    """Parse KDL text natively; None => the document needs Python
    semantics (every parse-error path among them, so errors carry the
    canonical message) and the caller must use the Python parser. Raises
    RuntimeError when a native library cannot be built."""
    if not text.isascii() and _unicode_divergence_risk(text):
        return None
    from ..core.kdl import KdlNode

    ext = _load_ext()
    if ext is not None:
        try:
            return ext.parse_nodes(text, KdlNode)   # None on parse error
        except UnicodeError:
            pass    # lone surrogates: the ctypes path encodes them below

    lib = load()

    raw = text.encode("utf-8", "surrogatepass")
    errbuf = ctypes.create_string_buffer(256)
    eline = ctypes.c_int32(0)
    ecol = ctypes.c_int32(0)
    handle = lib.ff_kdl_parse(raw, len(raw), errbuf, len(errbuf),
                              ctypes.byref(eline), ctypes.byref(ecol))
    if not handle:
        return None     # error or unsupported: Python parser decides
    try:
        n_nodes = ctypes.c_int64(0)
        n_vals = ctypes.c_int64(0)
        n_str = ctypes.c_int64(0)
        lib.ff_kdl_counts(handle, ctypes.byref(n_nodes),
                          ctypes.byref(n_vals), ctypes.byref(n_str))
        nn, nv, ns = n_nodes.value, n_vals.value, n_str.value

        parent, name_off, name_len = _i32(nn), _i32(nn), _i32(nn)
        type_off, type_len = _i32(nn), _i32(nn)
        val_start, nargs, nprops = _i32(nn), _i32(nn), _i32(nn)
        vkind = np.zeros(max(nv, 1), dtype=np.uint8)
        vint = np.zeros(max(nv, 1), dtype=np.int64)
        vnum = np.zeros(max(nv, 1), dtype=np.float64)
        vstr_off, vstr_len = _i32(nv), _i32(nv)
        vkey_off, vkey_len = _i32(nv), _i32(nv)
        strbuf = ctypes.create_string_buffer(max(ns, 1))

        lib.ff_kdl_export(
            handle,
            _pt(parent, ctypes.c_int32), _pt(name_off, ctypes.c_int32),
            _pt(name_len, ctypes.c_int32), _pt(type_off, ctypes.c_int32),
            _pt(type_len, ctypes.c_int32), _pt(val_start, ctypes.c_int32),
            _pt(nargs, ctypes.c_int32), _pt(nprops, ctypes.c_int32),
            _pt(vkind, ctypes.c_uint8), _pt(vint, ctypes.c_int64),
            _pt(vnum, ctypes.c_double),
            _pt(vstr_off, ctypes.c_int32), _pt(vstr_len, ctypes.c_int32),
            _pt(vkey_off, ctypes.c_int32), _pt(vkey_len, ctypes.c_int32),
            strbuf)
    finally:
        lib.ff_kdl_free(handle)

    buf = strbuf.raw[:ns]
    scache: dict[tuple[int, int], str] = {}

    def getstr(off: int, ln: int) -> str:
        key = (off, ln)
        s = scache.get(key)
        if s is None:
            s = buf[off:off + ln].decode("utf-8", "surrogatepass")
            scache[key] = s
        return s

    # plain-list indexing is ~3x faster than numpy scalars in this loop
    parent_l = parent.tolist()
    name_off_l, name_len_l = name_off.tolist(), name_len.tolist()
    type_off_l, type_len_l = type_off.tolist(), type_len.tolist()
    val_start_l = val_start.tolist()
    nargs_l, nprops_l = nargs.tolist(), nprops.tolist()
    vkind_l, vint_l, vnum_l = vkind.tolist(), vint.tolist(), vnum.tolist()
    vstr_off_l, vstr_len_l = vstr_off.tolist(), vstr_len.tolist()
    vkey_off_l, vkey_len_l = vkey_off.tolist(), vkey_len.tolist()

    # Materialize all values (and property keys) in one pass so node
    # assembly is list slicing, not per-index function calls — this loop is
    # the wrapper's hot path (a 10k-service doc has ~10^5 values).
    _KW = {0: None, 1: False, 2: True}   # VKind; .get so a skewed .so with
    vals: list = [None] * nv             # an unknown kind degrades to None
    keys: list = [None] * nv             # instead of crashing the load
    for j in range(nv):
        k = vkind_l[j]
        if k == 5:
            vals[j] = getstr(vstr_off_l[j], vstr_len_l[j])
        elif k == 3:
            vals[j] = vint_l[j]
        elif k == 4:
            vals[j] = vnum_l[j]
        else:
            vals[j] = _KW.get(k)
        ko = vkey_off_l[j]
        if ko >= 0:
            keys[j] = getstr(ko, vkey_len_l[j])

    new = KdlNode.__new__
    top: list[KdlNode] = []
    all_nodes: list[KdlNode] = []
    append_all = all_nodes.append
    for i in range(nn):
        vs = val_start_l[i]
        mid = vs + nargs_l[i]
        end = mid + nprops_l[i]
        to = type_off_l[i]
        # bypass the dataclass __init__ (measured ~2x on fleet-scale docs);
        # field set must stay in sync with core.kdl.KdlNode
        node = new(KdlNode)
        node.name = getstr(name_off_l[i], name_len_l[i])
        node.args = vals[vs:mid]
        node.props = dict(zip(keys[mid:end], vals[mid:end]))
        node.children = []
        node.type_annotation = getstr(to, type_len_l[i]) if to >= 0 else None
        append_all(node)
        p = parent_l[i]
        if p < 0:
            top.append(node)
        else:
            all_nodes[p].children.append(node)
    return top
