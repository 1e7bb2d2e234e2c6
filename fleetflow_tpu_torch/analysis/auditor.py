"""The launch auditor (port of ``analysis/auditor.py``): pin the launch
contracts of the hot dispatches by running them.

For every registered hot dispatch (solver/contracts.py), at every tier of
the audit's scale, this module runs the ACTUAL dispatch on the ACTUAL
production staging once, on a device, and reads the contract off the run.
The reference lowers each jitted executable and reads its artifact; the
mechanism has no torch counterpart, but each invariant it pins does:

  in_place      the reference's donation aliasing (``donated`` /
                ``aliased``): the tensors handed in whose storage was kept
                (``data_ptr()`` unchanged) and whose ``_version`` moved.
                Each of the contract's ``must_write_in_place`` tensors is
                in it, and no tensor handed in came back on a new storage
                — churn folds into the resident planes where they lie
  kept          the reference's "donation-free by design" pin: each
                ``must_keep`` input comes back bit-equal, on its storage,
                with its ``_version``
  host_traffic  the reference's host-callback purity and transfer guard:
                on the card, the host-to-device copies, device-to-host
                copies and synchronisations inside the dispatch's
                torch.profiler range. An upload inside a ``no_upload``
                dispatch is a violation; downloads and syncs are counted,
                not pinned (they move with the sweeps). Not measured on
                the CPU (``None``)
  output_devices  the reference's ``output_shardings``: every output lies
                on the dispatch's device ("dispatch"); one card has no
                shardings
  launches      (measured, not pinned) the kernels the dispatch launched,
                from ``_ext.LAUNCHES``: none on the CPU
  builds        the reference's recompile axes, at run time:
                ``_ext.M_COMPILE_EVENTS`` must not rise at any tier after a
                contract's first (a new tier builds nothing)
  static_args   the dispatch's declared host knobs, AST-extracted by
                analysis/jitspec, plus TorchProblem's non-tensor fields
                (``problem_static_fields``) at the top of the report
  problem_dtypes / output_dtypes  the dtypes of the staged problem's
                planes and of the outputs, as the reference's golden
                records them (the eligibility words are int32 with the
                reference's uint32 bits; the real-row count is a host int,
                a TorchProblem field, not a plane)

The device-independent part of the report diffs against the checked-in
contract (analysis/launch_contract.json): a new knob, a lost in-place
write or a changed output is a reviewed golden diff. Regenerate
intentionally with ``fleet --device cpu audit kernels --update``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Any, Optional

from .jitspec import extract_jit_decl

__all__ = ["audit_kernels", "audit_case", "contract_diff",
           "render_contract", "default_contract_path", "AuditReport",
           "PROBES", "h2d_in_range", "host_traffic_in_range", "profiled",
           "probe_seen"]

# the tier record's keys the golden pins; the others (host_traffic,
# builds, ms, launches) are measured and vary with the device and the run
PINNED_KEYS = ("in_place", "kept", "problem_dtypes", "output_dtypes",
               "output_devices")
AUDIT_RANGE = "fleet.audit"          # torch.profiler range prefix
LEAD_RANGE = "fleet.audit.lead"      # the untallied lead pass
# traces of the card's audit run until every range is seen (probe_seen)
H2D_TRIES = 3


class AuditReport(dict):
    """The audit result: a contract-file-shaped dict plus `violations`
    (intrinsic failures independent of any golden) and `skipped` (always
    empty here: no contract needs more devices than one card)."""

    @property
    def violations(self) -> list:
        return self["_violations"]

    @property
    def skipped(self) -> list:
        return self["_skipped"]

    def ok(self) -> bool:
        return not self["_violations"]


def default_contract_path() -> str:
    """analysis/launch_contract.json, beside this module in the package."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "launch_contract.json")


# -- torch.profiler: what host code inside a range made the card do ----------

PROBES = ("fleet.audit.h2d_probe", "fleet.audit.h2d_probe_after")


def _on_host(e) -> bool:
    return str(e.device_type).endswith("CPU")


def _index(prof):
    """One pass over a trace's events, kept on the profiler: the host
    events by name, the host's synchronize calls, and the earliest start
    of a host op that launched device work."""
    idx = getattr(prof, "_fleet_audit_index", None)
    if idx is None:
        by_name: dict = {}
        syncs = []
        first_launch = float("inf")
        for e in prof.events():
            if not _on_host(e):
                continue
            by_name.setdefault(e.name, []).append(e)
            if "Synchronize" in e.name:
                syncs.append(e)
            if e.kernels:
                first_launch = min(first_launch, e.time_range.start)
        idx = prof._fleet_audit_index = (by_name, syncs, first_launch)
    return idx


def host_traffic_in_range(prof, name: str) -> dict:
    """The work that host code inside the torch.profiler ranges called
    `name` put on the card (each device event is linked to the host op
    that launched it): ``ranges``, device ``ops``, ``h2d`` and ``d2h``
    copies as (host op, device event) names, and ``syncs``, the host's
    CUDA synchronize calls inside the ranges."""
    by_name, sync_events, _ = _index(prof)
    roots = by_name.get(name, [])
    ops, h2d, d2h = 0, [], []
    stack = list(roots)
    while stack:
        ev = stack.pop()
        for k in ev.kernels:
            ops += 1
            if "HtoD" in k.name:
                h2d.append((ev.name, k.name))
            elif "DtoH" in k.name:
                d2h.append((ev.name, k.name))
        stack.extend(ev.cpu_children)
    spans = [(r.thread, r.time_range.start, r.time_range.end) for r in roots]
    syncs = sum(1 for e in sync_events
                if any(e.thread == th and a <= e.time_range.start
                       and e.time_range.end <= b for th, a, b in spans))
    return dict(ranges=len(roots), ops=ops, h2d=h2d, d2h=d2h, syncs=syncs)


def h2d_in_range(prof, name: str) -> tuple[int, int, list]:
    """(ranges, device operations, host-to-device copies as (host op,
    device event) names) of the torch.profiler ranges called `name`."""
    t = host_traffic_in_range(prof, name)
    return t["ranges"], t["ops"], t["h2d"]


def profiled(run, device=None):
    """run() under torch.profiler, between two probe ranges that each
    upload one small tensor (they show that the count sees such a copy).
    Returns (run's result, profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..obs import CUDA_TRACE_LEAD_S
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one kernel, a sync and the lead first: the device tracing goes
        # live some ms after the profile is entered, and the records of
        # what ran before are lost
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        time.sleep(CUDA_TRACE_LEAD_S)
        with record_function(PROBES[0]):
            torch.tensor([1, 2, 3], device=dev)
        torch.cuda.synchronize(dev)
        out = run()
        torch.cuda.synchronize(dev)
        with record_function(PROBES[1]):
            torch.tensor([4, 5, 6], device=dev)
        torch.cuda.synchronize(dev)
    return out, prof


def probe_seen(prof, range_name: str):
    """(name, h2d_in_range) of the probe that shows this trace would have
    seen a copy in the `range_name` range, or None. The first probe shows
    it: it ran before the range. Late in a long process the profiler can
    lose every device record up to some point after that probe (on an
    H100 it lost them up to the traced run's first launches). Then the
    second probe shows that the trace links copies, and a device record
    linked to a host op that began before the range's host span shows
    that the kept records reach back before it (one stream: the card runs
    the ops in launch order)."""
    first, after = (h2d_in_range(prof, p) for p in PROBES)
    if first[0] == 1 and first[2]:
        return PROBES[0], first
    by_name, _syncs, first_launch = _index(prof)
    start = [e.time_range.start for e in by_name.get(range_name, [])]
    if after[0] == 1 and after[2] and len(start) == 1 \
            and first_launch < start[0]:
        return PROBES[1], after
    return None


# -- naming what a dispatch is handed and what it returns --------------------

def _torch():
    import torch
    return torch


def _leaves(obj, name: str, scalars: bool = False):
    """(dotted name, value) of every tensor inside `obj` (tuples and named
    tuples by position or field, dicts by key, dataclasses by field), and
    of every host int/float/bool when `scalars`. Lists are not entered:
    their length follows the run (the per-block telemetry rows)."""
    torch = _torch()
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif isinstance(obj, bool) or isinstance(obj, (int, float)):
        if scalars:
            yield name, obj
    elif isinstance(obj, tuple):
        fields = getattr(obj, "_fields", None)
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{name}.{fields[i] if fields else i}",
                               scalars)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{name}.{k}", scalars)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{name}.{f.name}",
                               scalars)


def _handed(case) -> dict:
    """Every tensor the case hands its dispatch, by argument name."""
    out: dict = {}
    for arg, value in zip(case.arg_names, case.args):
        out.update(_leaves(value, arg))
    for k, value in case.kwargs.items():
        out.update(_leaves(value, k))
    return out


def _generators(case) -> list:
    """The torch.Generators a case hands its dispatch (alone or in a
    list, as the lane path's are)."""
    torch = _torch()
    out = []
    for v in (*case.args, *case.kwargs.values()):
        for g in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(g, torch.Generator):
                out.append(g)
    return out


def _dtype(v) -> str:
    if isinstance(v, _torch().Tensor):
        return str(v.dtype).replace("torch.", "")
    return type(v).__name__


def _case_device(case, default):
    for _, t in _handed(case).items():
        return t.device
    return default


def _run_timed(case, dev):
    """Run the case once; returns (outputs, wall ms): CUDA events on the
    card, the host clock on the CPU."""
    torch = _torch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = case.fn(*case.args, **case.kwargs)
        end.record()
        end.synchronize()
        return out, float(start.elapsed_time(end))
    t0 = time.perf_counter()
    out = case.fn(*case.args, **case.kwargs)
    return out, (time.perf_counter() - t0) * 1e3


def audit_case(contract, case, device=None) -> tuple[dict, list[str]]:
    """Run one case once and read its record; returns the per-tier record
    and any intrinsic violations. ``host_traffic`` stays None here (the
    card's traced pass of :func:`audit_kernels` fills it)."""
    from .. import _ext
    torch = _torch()
    dev = _case_device(case, torch.device("cpu") if device is None
                       else torch.device(device))
    where = f"{contract.name}@{case.tier}"
    violations: list[str] = []
    before = {n: (t.data_ptr(), t._version) for n, t in _handed(case).items()}
    keep = {}
    for n in contract.must_keep:
        t = _handed(case).get(n)
        if t is None:
            violations.append(f"{where}: must-keep input {n} is not handed "
                              f"to the dispatch")
            continue
        keep[n] = (t.detach().clone(), t.data_ptr(), t._version)
    # the draws the run starts from: the card's traced pass replays them
    case.draws = [(g, g.get_state()) for g in _generators(case)]
    builds0 = _ext.M_COMPILE_EVENTS.value()
    launches0 = dict(_ext.LAUNCHES)
    out, ms = _run_timed(case, dev)
    builds = int(_ext.M_COMPILE_EVENTS.value() - builds0)
    launches = {k: n - launches0.get(k, 0) for k, n in _ext.LAUNCHES.items()
                if n != launches0.get(k, 0)}
    after = _handed(case)

    # ---- in place: storage kept, version moved ---------------------------
    in_place, replaced = [], []
    for n, (ptr, ver) in before.items():
        t = after.get(n)
        if t is None or t.data_ptr() != ptr:
            replaced.append(n)
        elif t._version != ver:
            in_place.append(n)
    missing = sorted(set(contract.must_write_in_place) - set(in_place))
    if missing:
        violations.append(
            f"{where}: not written in place: {', '.join(missing)} (the "
            f"dispatch no longer writes them where they lie)")
    if replaced:
        violations.append(
            f"{where}: handed tensors came back on a new storage: "
            f"{', '.join(sorted(replaced))} (a second copy of the plane; "
            f"the resident state must be written where it lies)")

    # ---- kept: bit-equal, same storage, same version ---------------------
    kept = []
    for n, (ref, ptr, ver) in keep.items():
        t = after.get(n)
        why = ("replaced" if t is None or t.data_ptr() != ptr else
               "written (its version moved)" if t._version != ver else
               "changed" if not torch.equal(t, ref) else None)
        if why is None:
            kept.append(n)
        else:
            violations.append(
                f"{where}: must-keep input {n} was {why}; it must outlive "
                f"the dispatch (a rejected attempt re-seeds from it)")

    # ---- packed problem planes -------------------------------------------
    dtype_rec: Optional[dict] = None
    if "prob" in case.arg_names:
        prob = case.args[case.arg_names.index("prob")]
        dtype_rec = {n: _dtype(v) for n, v in _leaves(prob, "prob")}
        if contract.packed_planes:
            if dtype_rec.get("prob.eligible") != "int32":
                violations.append(
                    f"{where}: eligibility plane is "
                    f"{dtype_rec.get('prob.eligible')}, not the bit-packed "
                    f"int32 words — a dense (S, N) plane is back in a hot "
                    f"dispatch")
            if "prob.preferred" in dtype_rec:
                violations.append(
                    f"{where}: a materialized preference plane "
                    f"({dtype_rec['prob.preferred']}) is staged into a hot "
                    f"dispatch — the packed layout keeps `preferred` absent "
                    f"when no service scores nodes")

    # ---- outputs: dtypes, and every one on the dispatch's device ---------
    outs = list(_leaves(out, "out", scalars=True))
    out_devices = {n: ("dispatch" if v.device == dev else str(v.device))
                   for n, v in outs if isinstance(v, torch.Tensor)}
    strays = sorted(n for n, d in out_devices.items() if d != "dispatch")
    if strays:
        violations.append(f"{where}: outputs off the dispatch's device "
                          f"{dev}: {', '.join(strays)}")

    rec = {
        "in_place": sorted(in_place),
        "kept": sorted(kept),
        "problem_dtypes": (dict(sorted(dtype_rec.items()))
                           if dtype_rec is not None else None),
        "output_dtypes": dict(sorted((n, _dtype(v)) for n, v in outs)),
        "output_devices": dict(sorted(out_devices.items())),
        "host_traffic": None,
        "builds": builds,
        "ms": ms,
        "launches": launches,
    }
    return rec, violations


def _anchor(contract):
    """(declaration, anchored object) of the contract's source anchor. A
    top-level name bound to a function of another module (an alias, as
    sharded.merge_sharded is resident.merge_delta) is read where it is
    defined."""
    mod = importlib.import_module(contract.module)
    obj = getattr(mod, contract.qualname, None) \
        if "." not in contract.qualname else None
    src, qual = mod, contract.qualname
    if callable(obj) and getattr(obj, "__module__", None) in sys.modules \
            and (obj.__module__, obj.__qualname__) != (contract.module,
                                                       contract.qualname):
        src, qual = sys.modules[obj.__module__], obj.__qualname__
    with open(src.__file__, encoding="utf-8") as f:
        decl = extract_jit_decl(f.read(), qual, os.path.basename(src.__file__))
    return decl, obj


def _trace_host_traffic(runs: list, dev, report: AuditReport,
                        tries: int = H2D_TRIES) -> None:
    """The card's traced pass: each (contract, case, record) of `runs`
    dispatched once more from its first run's draws (the generators'
    states replayed, so it sweeps as the first run did), inside its own
    profiler range, all in one trace. Late in a long process the profiler
    loses a trace's first device records (on an H100 up to the traced
    run's first launches, whatever the lead in time), and a range counts
    only when kept records reach back before it (probe_seen): so the
    measured pass follows an untallied lead pass over the same cases. The
    ranges no trace could see are traced again, alone, up to `tries`
    traces. Fills each record's host_traffic and adds the violations: an
    upload in a no-upload dispatch, a range no trace could see."""
    torch = _torch()
    from torch.profiler import record_function
    named = [(f"{AUDIT_RANGE}.{c.name}@{case.tier}", c, case, rec)
             for c, case, rec in runs]

    def dispatch(case):
        # the first run's draws again: the same sweeps, the same reads
        for g, state in case.draws:
            g.set_state(state)
        return case.fn(*case.args, **case.kwargs)

    def dispatch_all(pending):
        with record_function(LEAD_RANGE):
            for _name, _c, case, _rec in pending:
                dispatch(case)
        torch.cuda.synchronize(dev)
        for name, _c, case, _rec in pending:
            with record_function(name):
                dispatch(case)
            torch.cuda.synchronize(dev)

    seconds = report["_seconds"]
    for attempt in range(tries):
        pending = [r for r in named if r[3]["host_traffic"] is None]
        if not pending:
            break
        seconds["traces"] = attempt + 1
        t0 = time.perf_counter()
        _out, prof = profiled(lambda: dispatch_all(pending), dev)
        seconds["traced_runs"] = seconds.get("traced_runs", 0.0) + (
            time.perf_counter() - t0)
        for name, _c, _case, rec in pending:
            if probe_seen(prof, name) is not None:
                rec["host_traffic"] = host_traffic_in_range(prof, name)
    for name, c, case, rec in named:
        where = f"{c.name}@{case.tier}"
        t = rec["host_traffic"]
        if t is None:
            report["_violations"].append(
                f"{where}: host traffic not measured: no trace of {tries} "
                f"saw a probe's upload before its range")
        elif t["ranges"] != 1 or t["ops"] == 0:
            report["_violations"].append(
                f"{where}: no {name} dispatch traced ({t['ranges']} ranges, "
                f"{t['ops']} device operations)")
        elif c.no_upload and t["h2d"]:
            report["_violations"].append(
                f"{where}: host-to-device copies inside the warm dispatch: "
                f"{t['h2d']} — the warm path must move no problem tensor")


def audit_kernels(device=None, kernels=None, scale=None) -> AuditReport:
    """Run the full audit on `device` (default: the card; raises
    DeviceUnavailable without CUDA; ``"cpu"`` runs the plain versions);
    returns the report (contract-file shape plus `_violations`,
    `_skipped`, `_device`, `_scale`, `_host_traffic` — "measured", or
    "not measured on the cpu" — and `_seconds`: the host seconds of
    staging the cases, of their first runs and of the card's traced
    pass). `scale` is a
    contracts.AuditScale (default: the AUDIT_TIERS the golden pins)."""
    from ..device import resolve_device
    from ..solver.contracts import (audit_scale, hot_path_kernels,
                                    problem_static_fields)

    dev = resolve_device(device)
    scale = scale or audit_scale("tiers")
    if kernels is None:
        kernels = hot_path_kernels()
    report = AuditReport({
        "version": 1,
        "problem_static_fields": problem_static_fields(),
        "kernels": {},
        "_violations": [],
        "_skipped": [],
        "_device": str(dev),
        "_scale": scale.name,
    })
    runs = []
    seconds = report["_seconds"] = {"stage": 0.0, "run": 0.0, "trace": 0.0}
    for contract in kernels:
        decl, anchored = _anchor(contract)
        entry: dict = {"static_args": decl.static_args, "tiers": {}}
        t0 = time.perf_counter()
        cases = contract.cases(dev, scale)
        seconds["stage"] += time.perf_counter() - t0
        for i, case in enumerate(cases):
            t0 = time.perf_counter()
            rec, violations = audit_case(contract, case, dev)
            seconds["run"] += time.perf_counter() - t0
            where = f"{contract.name}@{case.tier}"
            if anchored is not None and case.fn is not anchored:
                got = getattr(case.fn, "__qualname__", case.fn)
                violations.append(f"{where}: the case dispatches {got}, not "
                                  f"the anchored {contract.qualname}")
            if i and rec["builds"]:
                violations.append(
                    f"{where}: {rec['builds']} kernel build(s) at a later "
                    f"tier (a new tier must build nothing)")
            entry["tiers"][case.tier] = rec
            report["_violations"].extend(violations)
            runs.append((contract, case, rec))
        report["kernels"][contract.name] = entry
    report["_host_traffic"] = ("measured" if dev.type == "cuda" else
                               f"not measured on the {dev.type}")
    if dev.type == "cuda" and runs:
        t0 = time.perf_counter()
        _trace_host_traffic(runs, dev, report)
        seconds["trace"] = time.perf_counter() - t0
    return report


def render_contract(report: AuditReport) -> str:
    """The contract-file text for a report: the device-independent part
    (stable ordering, trailing newline — a reviewable golden)."""
    doc: dict[str, Any] = {k: v for k, v in report.items()
                           if not k.startswith("_")}
    doc["kernels"] = {
        name: {**entry, "tiers": {
            tier: {k: rec[k] for k in PINNED_KEYS}
            for tier, rec in entry["tiers"].items()}}
        for name, entry in report["kernels"].items()}
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


def contract_diff(report: AuditReport, pinned: dict) -> list[str]:
    """Compare an audit report against the pinned contract document.
    Returns human-readable mismatches (empty = contract holds)."""
    out: list[str] = []
    if report["problem_static_fields"] != pinned.get(
            "problem_static_fields"):
        out.append(
            f"problem_static_fields drifted: audited "
            f"{report['problem_static_fields']}, pinned "
            f"{pinned.get('problem_static_fields')} — a new TorchProblem "
            f"field is host data every dispatch reads")
    pk = pinned.get("kernels", {})
    audited = report["kernels"]
    for name in sorted(set(pk) | set(audited)):
        if name not in audited:
            out.append(f"{name}: pinned in the contract but no longer "
                       f"registered in solver/contracts.py")
            continue
        if name not in pk:
            out.append(f"{name}: registered but absent from the contract "
                       f"file (run `fleet audit kernels --update`)")
            continue
        a, p = audited[name], pk[name]
        if a["static_args"] != p.get("static_args"):
            out.append(f"{name}: static args (host knobs) drifted: "
                       f"declaration says {a['static_args']}, contract "
                       f"pins {p.get('static_args')}")
        at, ptiers = a["tiers"], p.get("tiers", {})
        for tier in sorted(set(at) | set(ptiers)):
            if tier not in at:
                out.append(f"{name}@{tier}: pinned tier not audited "
                           f"(AUDIT_TIERS changed?)")
                continue
            if tier not in ptiers:
                out.append(f"{name}@{tier}: audited tier absent from the "
                           f"contract file")
                continue
            for key in PINNED_KEYS:
                if at[tier].get(key) != ptiers[tier].get(key):
                    out.append(
                        f"{name}@{tier}: {key} drifted: audited "
                        f"{at[tier].get(key)}, contract pins "
                        f"{ptiers[tier].get(key)}")
    return out
