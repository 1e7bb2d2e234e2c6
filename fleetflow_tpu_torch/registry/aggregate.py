"""Multi-fleet aggregation: the batch axis of the placement problem.

The reference's registry routes each (fleet, stage) to a single server and
defers real fan-out (SURVEY.md §2.10 "multi-fleet aggregation" row). Here
aggregation is what produces the solver's fleet-scale instances (BASELINE
config 4: 10k services x 1k nodes "multi-tenant via registry aggregation"):

  1. every registered fleet's stage is loaded and its services renamed
     into a `fleet.stage.service` namespace (dependencies rewritten),
  2. one combined Flow over the registry's shared server pool is lowered
     to a single ProblemTensors — host-port and volume conflicts unify
     across fleets automatically because conflict identity is the
     (ip, port, proto) / host-path key, not the fleet,
  3. deployment routes become per-row eligibility pins (a routed stage may
     only land on its routed server), the device-side analog of the
     reference's route resolution.

The result solves as ONE device-resident instance; the assignment maps back
through `AggregateIndex` to per-fleet, per-node deploy slices.

Churn re-aggregation is cached by CONTENT: pass a `FlowCache` and each
(fleet, stage)'s parse + namespace work is keyed on a hash of its KDL
bytes, so a single-fleet edit re-loads one fleet and reuses the other
N-1 — re-aggregation cost tracks what changed, not fleet count. (The
combined lowering still runs: it is vectorized in lower/tensors.py and is
the cheap half at fleet scale.)

The port's copy of ``fleetflow_tpu/registry/aggregate.py``, with one
deliberate difference: the lowered-instance disk tier carries the port's
``core.parsecache.CACHE_TAG`` in its file names and hashed keys, and its
code signature hashes the port's own ``lower/tensors.py``,
``core/model.py`` and this file. One ``FLEET_PARSE_CACHE`` directory may
serve both packages, and neither opens the other's instances. Nothing
here imports torch: the fork pool's workers never touch CUDA, in a
process that already holds a CUDA context too. The instance is placed by
the caller (the card's ``GpuSolverScheduler``); nothing here falls back.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..core.discovery import CONFIG_DIR_NAME
from ..core.loader import (_parse_workers as _ingest_workers,
                           load_project_from_root_with_stage)
from ..core.parsecache import CACHE_TAG, M_FRONTEND_PHASE_MS as _M_PHASE_MS
from ..core.model import Flow, Service, Stage
from ..lower.tensors import ProblemTensors, lower_stage
from ..obs import get_logger
from ..obs.metrics import REGISTRY
from .model import Registry

__all__ = ["AggregateIndex", "FlowCache", "aggregate_fleets",
           "fleet_content_hash", "fleet_stage_content_hash",
           "fleet_stage_hashes"]

log = get_logger("aggregate")

_M_CACHE = REGISTRY.counter(
    "fleet_registry_flow_cache_total",
    "Flow-cache lookups during registry aggregation, by outcome",
    labels=("outcome",))


@dataclass
class AggregateIndex:
    """Maps combined-instance rows back to their origin."""
    rows: list[tuple[str, str, str]] = field(default_factory=list)
    # (fleet, stage, service) per row, replica rows repeat the base name

    def slices_for_node(self, pt: ProblemTensors,
                        assignment: np.ndarray,
                        node: str) -> dict[tuple[str, str], list[str]]:
        """(fleet, stage) -> [service...] assigned to `node`."""
        j = pt.node_names.index(node)
        out: dict[tuple[str, str], list[str]] = {}
        for i in np.flatnonzero(np.asarray(assignment) == j):
            fleet, stage, svc = self.rows[int(i)]
            out.setdefault((fleet, stage), []).append(svc)
        return out


@dataclass
class FlowCache:
    """Content-hash keyed reuse of per-(fleet, stage) aggregation work.

    Entries hold the namespaced Service rows produced by one fleet-stage
    load. The rows are treated as IMMUTABLE once cached (aggregation only
    reads them; lowering only reads them), so reuse is reference sharing,
    not copying. Keyed per (fleet, stage) on the stage-scoped content hash
    (fleet_stage_hashes): churn that touches one stage's inputs re-lowers
    that stage only.

    ``lowered`` additionally caches the final whole-instance result
    (ProblemTensors + AggregateIndex) keyed on every entry hash + the
    route/server signature: a warm re-aggregation where NOTHING changed
    returns the previous lowering outright (the incremental-lower half of
    the front-end pipeline). The cached tensors are shared, not copied —
    the same read-only contract as the row entries."""
    entries: dict[tuple[str, Optional[str]], tuple[str, list[Service]]] = \
        field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    lowered: Optional[tuple] = None     # (instance key, pt, index)
    instance_hits: int = 0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self.entries),
                "instance_hits": self.instance_hits}


def _scan_include_targets(path: str, data: bytes) -> list[str]:
    """The on-disk paths a KDL file's `include "glob"` nodes match right
    now — a lightweight static scan (no expansion, no not-found errors:
    the loader reports those; the hash just has to cover what a load
    WOULD read). Line discipline and glob resolution are the parser's
    own helpers, so the scan cannot drift from what `_read_expanded`
    actually loads."""
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        return []
    if "include" not in text:
        return []
    from ..core.parser import (include_patterns_of_line,
                               resolve_include_pattern)

    base = os.path.dirname(os.path.realpath(path))
    out: list[str] = []
    for line in text.splitlines():
        patterns = include_patterns_of_line(line.strip())
        if not patterns:
            continue
        for pat in patterns:
            out.extend(resolve_include_pattern(pat, base)[0])
    return out


def _out_of_root_includes(file_data: list[tuple[str, bytes]]
                          ) -> list[tuple[str, list[str], bytes]]:
    """Follow `include` globs out of the walked file set: returns
    ``(realpath, sorted walked origins, bytes)`` for every file any
    walked (or transitively included) KDL file references that the walk
    itself did not hash — truly out-of-root files AND under-root files
    with names the walk skips (an `include "fragments/foo.conf"`, say).
    An edit to an included file OUTSIDE the root must invalidate the
    parse/lowered-instance caches exactly like an in-root edit.

    `file_data` carries the walked files' already-read bytes (the hash
    loop read them anyway — no second disk pass, no window for the
    scanned bytes to differ from the hashed bytes). Origins are exact
    under SHARING: each walked file's include closure is traversed
    separately (per-file scan/read results memoized), so a fragment two
    overlays both reach — directly or through a shared intermediate —
    lists both as origins and sinks into both scopes."""
    walked = {os.path.realpath(f) for f, _ in file_data}
    datas: dict[str, bytes] = {}         # out-of-walk realpath -> bytes
    targets: dict[str, list[str]] = {}   # memoized per-file scan
    origins: dict[str, set] = {}         # -> walked files reaching it

    def read(rt: str) -> bytes:
        if rt not in datas:
            try:
                with open(rt, "rb") as fh:
                    datas[rt] = fh.read()
            except OSError:
                datas[rt] = b"<unreadable>"
        return datas[rt]

    def targets_of(rt: str) -> list[str]:
        if rt not in targets:
            targets[rt] = (_scan_include_targets(rt, read(rt))
                           if rt.endswith(".kdl") else [])
        return targets[rt]

    for f, data in file_data:
        if not f.endswith(".kdl"):
            continue
        stack = [os.path.realpath(t)
                 for t in _scan_include_targets(f, data)]
        visited: set[str] = set()
        while stack:
            rt = stack.pop()
            if rt in walked or rt in visited:
                continue
            visited.add(rt)
            read(rt)
            origins.setdefault(rt, set()).add(f)
            stack.extend(os.path.realpath(t) for t in targets_of(rt))
    return [(rt, sorted(origins[rt]), datas[rt]) for rt in sorted(origins)]


def fleet_content_hash(path: str) -> str:
    """Hash of the load inputs for a fleet root: every *.kdl and .env*
    file under it (names + bytes, sorted walk), every file its `include`
    globs reach OUTSIDE the root (followed transitively: an edit to an
    out-of-root included file must invalidate like an in-root edit),
    plus the allowlisted process env
    (FLEET_*/CI_*/APP_* — the loader injects those into the template
    context, so an export must invalidate just like an edit)."""
    from ..core.template import ENV_ALLOWLIST_PREFIXES

    h = hashlib.sha256()
    if os.path.isfile(path):
        files = [path]
    else:
        files = []
        for root, dirs, names in os.walk(path):
            dirs.sort()
            for n in sorted(names):
                if n.endswith(".kdl") or n.startswith(".env"):
                    files.append(os.path.join(root, n))
    file_data: list[tuple[str, bytes]] = []
    for f in files:
        try:
            with open(f, "rb") as fh:
                data = fh.read()
        except OSError:
            data = b"<unreadable>"
        file_data.append((f, data))
        h.update(f.encode())
        h.update(data)
    for rt, _srcs, data in _out_of_root_includes(file_data):
        h.update(rt.encode())
        h.update(data)
    for k in sorted(os.environ):
        if k.startswith(ENV_ALLOWLIST_PREFIXES):
            h.update(f"{k}={os.environ[k]}".encode())
    return h.hexdigest()


_INSTANCE_CACHE_VERSION = 1
_code_sig: Optional[str] = None


def _instance_code_sig() -> str:
    """Digest of the lowering-relevant source files, folded into the disk
    tag: a checkout that changes what lowering PRODUCES must miss the
    persisted instances (content hashes only cover the config inputs)."""
    global _code_sig
    if _code_sig is None:
        h = hashlib.sha256()
        from ..core import model as _model
        from ..lower import tensors as _tensors
        for src in (_tensors.__file__, _model.__file__, __file__):
            try:
                with open(src, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"<unreadable>")
        _code_sig = h.hexdigest()
    return _code_sig


def _instance_disk_dir() -> Optional[str]:
    # the lowered-instance tier lives alongside the parse cache — one
    # knob (FLEET_PARSE_CACHE) turns the whole front-end disk story on
    d = os.environ.get("FLEET_PARSE_CACHE", "").strip()
    return d or None


def _instance_path(inst_key: tuple) -> Optional[str]:
    d = _instance_disk_dir()
    if d is None:
        return None
    tag = hashlib.sha256(
        repr((CACHE_TAG, _INSTANCE_CACHE_VERSION, _instance_code_sig())
             + inst_key).encode()).hexdigest()
    return os.path.join(d, f"{CACHE_TAG}-instance-{tag[:40]}.pkl")


def _instance_disk_get(inst_key: tuple):
    from ..core.parsecache import disk_pickle_get

    path = _instance_path(inst_key)
    if path is None:
        return None
    return disk_pickle_get(path, _INSTANCE_CACHE_VERSION,
                           (CACHE_TAG,) + inst_key)


def _instance_disk_put(inst_key: tuple, pt, index) -> None:
    from ..core.parsecache import disk_pickle_put

    path = _instance_path(inst_key)
    if path is not None:
        disk_pickle_put(path, _INSTANCE_CACHE_VERSION,
                        (CACHE_TAG,) + inst_key, pt, index)


def _stage_scoped(path: str, fleet_root: str) -> Optional[str]:
    """The stage a file is scoped to, or None for fleet-common files.
    ``flow.{stage}.kdl`` and ``.env.{stage}`` only enter a load for their
    own stage (`.env.external` and `flow.local.kdl` are part of EVERY
    load, so they stay common). Scoping applies ONLY where discovery
    treats the name specially — the fleet root and its config dir; a
    stage-looking name under services/ or stages/ is loaded for every
    stage and must hash as common."""
    parent = os.path.normpath(os.path.dirname(os.path.abspath(path)))
    root = os.path.normpath(os.path.abspath(fleet_root))
    if parent not in (root, os.path.join(root, CONFIG_DIR_NAME)):
        return None
    name = os.path.basename(path)
    if name.startswith("flow.") and name.endswith(".kdl"):
        stage = name[len("flow."):-len(".kdl")]
        if stage and stage != "local" and "." not in stage:
            return stage
    elif name.startswith(".env.") and name != ".env.external":
        return name[len(".env."):]
    return None


def fleet_stage_hashes(path: str, stages: list[str]) -> dict[str, str]:
    """Per-stage content hashes in ONE walk: each stage's digest covers
    the fleet-common load inputs plus only that stage's scoped files
    (flow.{stage}.kdl, .env.{stage}) and the allowlisted env. An edit to
    flow.prod.kdl then invalidates the prod rows only — single-stage
    churn re-lowers one stage instead of one fleet. `include` globs are
    followed out of the fleet root (transitively), sinking into the
    including file's scope: an edit to a shared out-of-root fragment
    invalidates exactly the stages that load it."""
    from ..core.template import ENV_ALLOWLIST_PREFIXES

    scoped = {s: hashlib.sha256() for s in stages}
    if os.path.isfile(path):
        files = [path]
    else:
        files = []
        for root, dirs, names in os.walk(path):
            dirs.sort()
            for n in sorted(names):
                if n.endswith(".kdl") or n.startswith(".env"):
                    files.append(os.path.join(root, n))
    relevant: list[tuple[str, bytes]] = []    # files that sink somewhere
    for f in files:
        stage = _stage_scoped(f, path)
        if stage is not None and stage not in scoped:
            continue            # another stage's overlay: not our input
        try:
            with open(f, "rb") as fh:
                data = fh.read()
        except OSError:
            data = b"<unreadable>"
        relevant.append((f, data))
        sinks = [scoped[stage]] if stage is not None else \
            list(scoped.values())
        for sink in sinks:
            sink.update(f.encode())
            sink.update(data)
    for rt, srcs, data in _out_of_root_includes(relevant):
        # included content enters through the file(s) that include it,
        # so it sinks into the union of their scopes (a stage overlay's
        # include -> that stage only; any common includer -> every stage)
        src_stages = {_stage_scoped(src, path) for src in srcs}
        if None in src_stages:
            sinks = list(scoped.values())
        else:
            sinks = [scoped[s] for s in sorted(src_stages) if s in scoped]
        for sink in sinks:
            sink.update(rt.encode())
            sink.update(data)
    env_blob = b"".join(
        f"{k}={os.environ[k]}".encode() for k in sorted(os.environ)
        if k.startswith(ENV_ALLOWLIST_PREFIXES))
    out: dict[str, str] = {}
    for s, h in scoped.items():
        h.update(env_blob)
        out[s] = h.hexdigest()
    return out


def fleet_stage_content_hash(path: str, stage: str) -> str:
    """Single-stage convenience over :func:`fleet_stage_hashes` — the
    default ``content_hash`` for aggregation (two-parameter form)."""
    return fleet_stage_hashes(path, [stage])[stage]


def _namespace(fleet: str, stage: str, name: str) -> str:
    return f"{fleet}.{stage}.{name}"


def _load_rows(loader, path: str, fleet_name: str,
               stage_name: str) -> list[Service]:
    """Load one fleet stage and namespace its service rows."""
    # load PER STAGE: stage-scoped variables, .env.{stage}, and
    # flow.{stage}.kdl overlays only apply when the loader knows
    # which stage it is building
    flow = loader(path, stage_name)
    stage = flow.stage(stage_name)
    prefix = f"{fleet_name}.{stage_name}."
    rename = {s: prefix + s for s in stage.services}
    rows: list[Service] = []
    for svc in stage.resolved_services(flow):
        # shallow_copy + rebind: dataclasses.replace costs ~5x
        # more and this loop runs once per service row (model.py
        # shallow_copy docstring)
        nsvc: Service = svc.shallow_copy()
        nsvc.name = rename[svc.name]
        # rebind only what actually rewrites: empty lists stay shared
        # with the base object (read-only), saving 3 listcomps per row
        if svc.depends_on:
            nsvc.depends_on = [rename[d] for d in svc.depends_on
                               if d in rename]
        if svc.colocate_with:
            nsvc.colocate_with = [prefix + c for c in svc.colocate_with]
        if svc.anti_affinity:
            nsvc.anti_affinity = [prefix + a for a in svc.anti_affinity]
        rows.append(nsvc)
    return rows


def _load_rows_job(args: tuple) -> list[Service]:
    """Worker-side fleet-stage load (module-level: must pickle). Only the
    DEFAULT loader runs here — injected loader callables stay in-process."""
    path, fleet_name, stage_name = args
    os.environ["FLEET_PARSE_WORKERS"] = "0"   # no pools inside the pool
    return _load_rows(
        lambda p, s: load_project_from_root_with_stage(p, s),
        path, fleet_name, stage_name)


def _parallel_load_rows(misses: list[tuple[str, str, str]],
                        workers: int) -> Optional[list[list[Service]]]:
    """Load several (path, fleet, stage) row sets across a fork pool;
    None when the pool is unavailable (caller falls back to serial)."""
    try:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context("fork")
        with ProcessPoolExecutor(max_workers=min(workers, len(misses)),
                                 mp_context=ctx) as ex:
            return list(ex.map(_load_rows_job, misses))
    except Exception as e:
        from ..core.errors import FlowError
        if isinstance(e, FlowError):
            raise
        log.debug("parallel fleet ingest unavailable (%s); loading "
                  "serially", e)
        return None


def aggregate_fleets(
        registry: Registry,
        stages: Optional[dict[str, list[str]]] = None,
        loader: Callable[[str, str], Flow] = None,
        cache: Optional[FlowCache] = None,
        content_hash: Optional[Callable] = None,
) -> tuple[ProblemTensors, AggregateIndex]:
    """Build one placement instance from every registered fleet.

    `stages` restricts which stages per fleet (default: every stage named in
    the fleet's routes, else every stage in its config). `loader` is
    injectable for tests (defaults to the real project loader). `cache`
    (a FlowCache, caller-held across aggregations) skips the load+namespace
    of any fleet-stage whose content hash is unchanged. `content_hash`
    accepts either the per-stage two-parameter form ``(path, stage)`` (the
    default, :func:`fleet_stage_content_hash` — single-STAGE churn then
    re-lowers one stage) or the legacy one-parameter ``(path)`` fleet-wide
    form. With ``FLEET_PARSE_WORKERS>1`` and the default loader, cache
    misses load across a process pool.
    """
    t_lower0 = time.perf_counter()
    default_loader = loader is None
    loader = loader or (lambda path, stage:
                        load_project_from_root_with_stage(path, stage))

    if content_hash is None:
        hash_for = fleet_stage_content_hash
        per_stage_hash = True
    else:
        try:
            per_stage_hash = \
                len(inspect.signature(content_hash).parameters) >= 2
        except (TypeError, ValueError):   # builtins/C callables
            per_stage_hash = False
        hash_for = (content_hash if per_stage_hash
                    else lambda path, _stage: content_hash(path))

    combined = Flow(name="registry")
    combined.servers = dict(registry.servers)
    combined_stage = Stage(name="aggregate")
    pins: dict[str, str] = {}          # namespaced service -> pinned server

    # pass 1: resolve wanted stages + cache state per (fleet, stage)
    plan: list[tuple[str, str, str, Optional[str],
                     Optional[list[Service]]]] = []
    for fleet_name, entry in sorted(registry.fleets.items()):
        routed = {r.stage: r.server
                  for r in registry.routes_for_fleet(fleet_name)}
        if stages and fleet_name in stages:
            wanted = stages[fleet_name]
        elif routed:
            wanted = sorted(routed)
        else:
            # discover the fleet's stages with a stage-neutral load
            wanted = sorted(loader(entry.path, None).stages)

        fleet_hashes: dict[str, str] = {}
        if cache is not None:
            if per_stage_hash and hash_for is fleet_stage_content_hash:
                fleet_hashes = fleet_stage_hashes(entry.path, list(wanted))
            elif per_stage_hash:
                fleet_hashes = {s: hash_for(entry.path, s) for s in wanted}
            else:
                # legacy fleet-wide hash: one walk per FLEET, not one per
                # stage (fleet_content_hash re-reads the whole dir)
                h = hash_for(entry.path, None)
                fleet_hashes = {s: h for s in wanted}
        for stage_name in wanted:
            fhash = fleet_hashes.get(stage_name)
            rows = None
            if cache is not None:
                hit = cache.entries.get((fleet_name, stage_name))
                if hit is not None and hit[0] == fhash:
                    rows = hit[1]
                    cache.hits += 1
                    _M_CACHE.inc(outcome="hit")
            plan.append((fleet_name, stage_name, entry.path, fhash, rows))

    # whole-instance reuse: when EVERY (fleet, stage) hash is known and
    # unchanged and the route/server signature matches, the previous
    # lowering is the answer — a warm re-aggregation of an unchanged
    # registry costs a hash walk, not a lower. The key is pure content
    # (entry hashes + routes + a server-content digest), so it also keys
    # a DISK tier next to the parse cache: a fresh process (CP restart,
    # the bench's warm child) reuses the previous process's lowering.
    routes_sig = tuple(sorted(
        (f, r.stage, r.server)
        for f in registry.fleets for r in registry.routes_for_fleet(f)))
    inst_key = None
    if cache is not None and plan and \
            all(h is not None for _f, _s, _p, h, _r in plan):
        servers_sig = hashlib.sha256(
            repr(sorted(registry.servers.items(),
                        key=lambda kv: kv[0])).encode()).hexdigest()
        inst_key = (tuple((f, s, h) for f, s, _p, h, _r in plan),
                    routes_sig, servers_sig)
        if cache.lowered is not None and cache.lowered[0] == inst_key:
            cache.instance_hits += 1
            _M_CACHE.inc(outcome="instance_hit")
            _M_PHASE_MS.set((time.perf_counter() - t_lower0) * 1e3,
                            phase="lower")
            return cache.lowered[1], cache.lowered[2]
        disk = _instance_disk_get(inst_key)
        if disk is not None:
            cache.lowered = (inst_key,) + disk
            cache.instance_hits += 1
            _M_CACHE.inc(outcome="instance_disk_hit")
            _M_PHASE_MS.set((time.perf_counter() - t_lower0) * 1e3,
                            phase="lower")
            return disk

    # pass 2: load the misses — across the worker pool when allowed
    misses = [(path, f, s) for f, s, path, _h, rows in plan if rows is None]
    loaded: dict[tuple[str, str], list[Service]] = {}
    workers = _ingest_workers()
    if default_loader and workers > 1 and len(misses) > 1:
        results = _parallel_load_rows(misses, workers)
        if results is not None:
            for (path, f, s), rows in zip(misses, results):
                loaded[(f, s)] = rows

    # pass 3: merge in deterministic plan order
    routed_by_fleet = {f: {r.stage: r.server
                           for r in registry.routes_for_fleet(f)}
                       for f in registry.fleets}
    for fleet_name, stage_name, path, fhash, rows in plan:
        if rows is None:
            rows = loaded.get((fleet_name, stage_name))
            if rows is None:
                rows = _load_rows(loader, path, fleet_name, stage_name)
            if cache is not None:
                cache.entries[(fleet_name, stage_name)] = (fhash, rows)
                cache.misses += 1
                _M_CACHE.inc(outcome="miss")
        services = combined.services
        stage_list = combined_stage.services
        pin = routed_by_fleet[fleet_name].get(stage_name)
        for nsvc in rows:
            services[nsvc.name] = nsvc
            stage_list.append(nsvc.name)
            if pin is not None:
                pins[nsvc.name] = pin

    combined.stages = {"aggregate": combined_stage}
    pt = lower_stage(combined, "aggregate",
                     nodes=list(registry.servers.values()))

    # deployment routes -> per-row eligibility pins
    if pins:
        node_idx = {n: j for j, n in enumerate(pt.node_names)}
        eligible = pt.eligible.copy()
        for i, row in enumerate(pt.service_names):
            base = row.split("#", 1)[0]
            server = pins.get(base)
            if server is not None:
                mask = np.zeros(pt.N, dtype=bool)
                mask[node_idx[server]] = True
                eligible[i] = mask
        pt.eligible = eligible

    # pt.replica_of already carries the base (un-#-suffixed) namespaced
    # name per row; memoize the 3-way split per unique base instead of
    # re-splitting every replica row (~35 ms at 10k rows)
    memo: dict[str, tuple[str, str, str]] = {}
    rows_idx = []
    for base in pt.replica_of:
        t = memo.get(base)
        if t is None:
            t = memo[base] = tuple(base.split(".", 2))  # type: ignore[misc]
        rows_idx.append(t)
    index = AggregateIndex(rows=rows_idx)
    if cache is not None and inst_key is not None:
        cache.lowered = (inst_key, pt, index)
        _instance_disk_put(inst_key, pt, index)
    _M_PHASE_MS.set((time.perf_counter() - t_lower0) * 1e3, phase="lower")
    return pt, index
