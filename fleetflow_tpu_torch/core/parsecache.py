"""Content-addressed parse cache: the front end's analog of a compile
cache.

Parsing a fleet-scale project costs far more than placing it, and a fresh
process re-pays it on every start. Parsing is a pure function of the
rendered text, so it caches the same way compilation does:

  sha256(rendered file bytes) -> parsed Flow fragment

Two tiers:

  * an in-memory LRU (``FLEET_PARSE_CACHE_MEM`` entries, default 128) —
    warm re-loads inside one process (CP reconverge, chaos replay, watch
    loops) skip the parser entirely;
  * an optional on-disk pickle directory (``FLEET_PARSE_CACHE=dir``, the
    knob mirroring ``FLEET_COMPILE_CACHE``) — a fresh process (CP restart,
    ``fleet lint`` in CI, the bench's cold/warm children) reuses fragments
    parsed by an earlier one. Entries are versioned; a format bump
    invalidates stale files instead of mispickling them.

Cache values are FRAGMENTS and treated as immutable: `parse_kdl_string`
hands callers a thawed copy (fresh top-level containers, per-service
shallow copies) and merges fragments into target flows without ever
mutating the cached objects — the same read-only discipline the registry
FlowCache established for aggregation rows. Keys are content hashes, so
invalidation is automatic: editing one file changes one key, and a
multi-file project re-parses exactly the files that changed (the lint
span path additionally keys on the file's line offset inside the loader's
concatenation, so diagnostics keep byte-exact positions).

Texts below ``FLEET_PARSE_CACHE_MIN`` bytes (default 2048) are not cached:
small ad-hoc parses (tests, wizard snippets) gain nothing and must never
observe shared state.

This is the port's copy of ``fleetflow_tpu/core/parsecache.py``, with one
deliberate difference: its disk entries carry the package's own tag
(``CACHE_TAG``) in their file names and in the hashed key. One
``FLEET_PARSE_CACHE`` directory may serve both packages, and each unpickles
only its own entries: the other package's pickled fragments would import
that package and hand back its model classes.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
from collections import OrderedDict
from typing import Any, Optional

from ..obs import get_logger
from ..obs.metrics import REGISTRY

__all__ = ["ParseCache", "default_parse_cache", "parse_cache_stats",
           "parse_cache_clear", "PARSE_CACHE_VERSION",
           "disk_pickle_get", "disk_pickle_put", "M_FRONTEND_PHASE_MS",
           "CACHE_TAG"]

log = get_logger("parsecache")

# bump when the parser's output shape changes (KdlNode/model fields,
# fragment semantics) — stale disk entries then miss instead of mispickle
PARSE_CACHE_VERSION = 1

# the disk entries' package tag: part of every file name and hashed key, so
# this package never opens another package's entry (nor that one this one's)
CACHE_TAG = "fleetflow_tpu_torch"

# the front-end phase gauge lives here (the front end's neutral leaf
# module): core/loader.py reads it from here; solver/api.py gets the same
# family by get-or-create (same name, HELP and labels), so the solver
# never imports the front end
M_FRONTEND_PHASE_MS = REGISTRY.gauge(
    "fleet_frontend_phase_ms",
    "Milliseconds of the most recent front-end phase: parse (per-file "
    "fragment parsing incl. cache lookups), lower (aggregation + tensor "
    "lowering), stage (host->device staging)",
    labels=("phase",))

_M_CACHE = REGISTRY.counter(
    "fleet_frontend_parse_cache_total",
    "Content-addressed parse-cache lookups, by outcome "
    "(hit = in-memory, disk_hit = loaded from FLEET_PARSE_CACHE, "
    "miss = parsed fresh)",
    labels=("outcome",))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- shared pickle-dir protocol ---------------------------------------------
# one implementation of the versioned-entry file format: the parse cache
# and the registry's lowered-instance tier (registry/aggregate.py) both
# speak it, so version checks / corrupt-entry handling / atomic writes
# stay in sync by construction

def disk_pickle_get(path: str, version: int, key: tuple) -> Optional[tuple]:
    """Load a versioned pickle entry; None on absent/stale/corrupt
    (corrupt entries are unlinked). Returns the stored payload tuple."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as f:
            stored_version, stored_key, *payload = pickle.load(f)
        if stored_version != version or stored_key != key:
            return None
        return tuple(payload)
    except Exception as e:   # corrupt/stale entry: miss, then drop it
        log.debug("dropping unreadable cache entry %s: %s", path, e)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def disk_pickle_put(path: str, version: int, key: tuple, *payload) -> None:
    """Atomically write a versioned pickle entry; failures are logged and
    swallowed — a cache write must never fail the operation it rides."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump((version, key) + payload, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)   # atomic: readers never see a torn file
    except Exception as e:
        log.debug("cache write failed for %s: %s", path, e)


class ParseCache:
    """Two-tier (memory LRU + optional pickle dir) fragment cache."""

    def __init__(self, max_entries: Optional[int] = None,
                 disk_dir: Optional[str] = None):
        if max_entries is None:
            max_entries = _env_int("FLEET_PARSE_CACHE_MEM", 128)
        if disk_dir is None:
            disk_dir = os.environ.get("FLEET_PARSE_CACHE", "").strip() or None
        self.max_entries = max_entries
        self.disk_dir = disk_dir
        self._mem: OrderedDict[tuple, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.disk_hits = 0
        self.misses = 0

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def key(text: str, want_spans: bool = False,
            source: Optional[str] = None, line_offset: int = 0) -> tuple:
        """Cache key for one rendered text. Spans bake the concatenation
        line offset and source label into the nodes, so span-carrying
        parses key on them too; span-less parses (the hot path) key on
        content alone and survive offset drift from edits in earlier
        files."""
        h = hashlib.sha256(text.encode("utf-8", "surrogatepass")).hexdigest()
        if want_spans:
            return (h, True, source, line_offset)
        return (h, False, None, 0)

    # -- lookup / insert ----------------------------------------------------

    def get(self, key: tuple) -> Optional[Any]:
        with self._lock:
            frag = self._mem.get(key)
            if frag is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                _M_CACHE.inc(outcome="hit")
                return frag
        frag = self._disk_get(key)
        if frag is not None:
            self.disk_hits += 1
            _M_CACHE.inc(outcome="disk_hit")
            self._mem_put(key, frag)
            return frag
        self.misses += 1
        _M_CACHE.inc(outcome="miss")
        return None

    def put(self, key: tuple, frag: Any) -> None:
        self._mem_put(key, frag)
        self._disk_put(key, frag)

    def adopt(self, key: tuple, frag: Any) -> None:
        """Memory-tier-only insert — for fragments a pool worker already
        parsed (and disk-persisted) on the parent's behalf."""
        self._mem_put(key, frag)

    def _mem_put(self, key: tuple, frag: Any) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._mem[key] = frag
            self._mem.move_to_end(key)
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)

    # -- disk tier ----------------------------------------------------------

    def _disk_path(self, key: tuple) -> Optional[str]:
        if not self.disk_dir:
            return None
        tag = hashlib.sha256(
            repr((CACHE_TAG, PARSE_CACHE_VERSION) + key).encode()
        ).hexdigest()[:16]
        return os.path.join(self.disk_dir,
                            f"{CACHE_TAG}-{key[0][:32]}-{tag}.pkl")

    def _disk_get(self, key: tuple) -> Optional[Any]:
        path = self._disk_path(key)
        if path is None:
            return None
        payload = disk_pickle_get(path, PARSE_CACHE_VERSION,
                                  (CACHE_TAG,) + key)
        return payload[0] if payload is not None else None

    def _disk_put(self, key: tuple, frag: Any) -> None:
        path = self._disk_path(key)
        if path is not None:
            disk_pickle_put(path, PARSE_CACHE_VERSION, (CACHE_TAG,) + key,
                            frag)

    # -- maintenance --------------------------------------------------------

    def stats(self) -> dict:
        return {"hits": self.hits, "disk_hits": self.disk_hits,
                "misses": self.misses, "entries": len(self._mem),
                "disk_dir": self.disk_dir}

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
        self.hits = self.disk_hits = self.misses = 0


_default: Optional[ParseCache] = None
_default_lock = threading.Lock()


def default_parse_cache() -> ParseCache:
    """Process-wide cache instance (env-configured, built on first use).
    Re-built if FLEET_PARSE_CACHE / FLEET_PARSE_CACHE_MEM changed since —
    tests and the bench's subprocess legs flip these at runtime."""
    global _default
    want_dir = os.environ.get("FLEET_PARSE_CACHE", "").strip() or None
    want_mem = _env_int("FLEET_PARSE_CACHE_MEM", 128)
    with _default_lock:
        if (_default is None or _default.disk_dir != want_dir
                or _default.max_entries != want_mem):
            _default = ParseCache(max_entries=want_mem, disk_dir=want_dir)
        return _default


def parse_cache_stats() -> dict:
    return default_parse_cache().stats()


def parse_cache_clear() -> None:
    default_parse_cache().clear()
