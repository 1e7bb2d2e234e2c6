#!/usr/bin/env python3
"""Build and drive the fleetflow_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. It imports nothing of JAX or of ``fleetflow_tpu``. Phases,
each of which fails the run:

  1. print the card (nvidia-smi name and power limit) and build the seven
     CUDA kernels from ``fleetflow_tpu_torch/csrc`` (nvcc) and the host
     placer (g++), all in parallel;
  2. hold K1-K4 and K6 against their plain PyTorch versions on the same
     inputs at the headline size, synthetic_problem(10000, 1000, seed=0,
     n_tenants=8, port_fraction=0.2, volume_fraction=0.1), and time both
     with CUDA events (K4 and K3 also on the 2000x200 mux tier's
     staging; ``[k6_scan]``: K6 also at 2000x200 with pack,
     fill_lowest and a best-effort instance, the same instance in strict
     mode (``best_effort=False``), and at 512 x 3,000 with a
     preference plane (more nodes than a block has threads), each size
     with its microseconds a step; K1 timed at T = 1 and T = 1e-3); then
     K1-K3 with a lane axis,
     at 8 lanes of 2000x200 and 2 lanes of the padded phase-4 fleet,
     against their plain versions and against the solo kernel launched
     lane by lane; K2 on the mux leg's 2000x200 and 900x100 stagings with
     one node and 15% of the nodes down, stage 0 alone and 8 stages as
     lanes, against its plain version, each size timed with its
     iterations; ``[k7]``: K7, the sharded sweep, against its plain
     version on one-card meshes of 1x8 and 2x4 positions at the sharded
     fleet (SHARDED_SHAPE, the partitioned seed with 5% of the nodes
     down, 8 sweeps through one bound launcher), a sweep timed as the
     anneal loop launches it at the warm schedule's start and end
     temperatures, with the launcher's host ms; ``[rows]``: the CUDA-event ms and the bound of the rows
     without a kernel (pad_problem_tiers, the carried-state reductions,
     and the summed lane bounds of ``_mux_refine``);
  3. ``[main]``: the unbucketed path without the active-set sub-solve
     (``GpuSolverScheduler(bucket=False)`` with FLEET_SUBSOLVE=0): a cold
     place of the fleet, then warm reschedules after one node down, 5% of
     the nodes down and a capacity refresh; one more reschedule under
     torch.profiler must make no host-to-device copy in its refine range;
  4. ``[default]``: ``GpuSolverScheduler()`` as a user creates it
     (bucketed staging with phantom rows, sub-solve on) on the headline
     fleet plus a 200-row tenant stage that starts inert: a cold place over
     the padded rows, the burst pattern kill1, arrive, kill3, depart,
     arrive, kill3 (each kill takes the busiest live nodes and revives
     those killed two bursts before; arrive/depart scatter the tenant's
     rows), one arrival of 64 id-free services into phantom rows
     (ProblemDelta(n_real=...)), and 8 rolling kills of the busiest node.
     At least one burst must be localized and two mini tiers exercised;
     one more localized reschedule under torch.profiler must make no
     host-to-device copy in its sub-solve range; every sub-solve's K5
     stage is held against its plain version on CPU copies of the
     resident staging with the host mirror as the assignment (so a mirror
     that drifts from the device shows), its plan uploaded as one copy of
     O(tier) int32s; K5 (stage, commit) also on the plan of a kill3 burst,
     timed by entry point, with ``[planner]``'s host split;
  5. ``[ab]``: phase 4's solves replayed on fresh schedulers with the same
     node masks, the sub-solve off (FLEET_SUBSOLVE=0) and on, in the order
     off, on, on, off; one line per solve with its wall ms both ways;
     then ``[obs]``, the port's observability, outside every profiler
     window: a cold place of the phase-4 fleet and three bursts (one node
     down, 64 arrivals, 5% down with the sub-solve off), a K = 3
     ``solve_multiplexed`` batch and a cold 1x8 ``solve_sharded`` with
     FLEET_TRACE_FILE set, the registry's counters moved exactly as those
     calls imply and one ``solve.trace`` record a solve holding its
     telemetry; FLEET_PROFILE_SOLVER=1's dispatch delta read from the
     allocator; FLEET_PROFILE_DIR's Chrome trace of a cold solve with its
     ranges and K4's, K3's and K1's kernel events; the per-solve
     bookkeeping's host µs, at most 1% of the median of ``[ab]``'s
     sub-solve-off 0-sweep bursts, printed with the card line;
  6. ``[mux]``: the tenant multiplexer (FLEET_SUBSOLVE=0). Stages of the
     reference bench's mux leg, synthetic_problem(S, N, seed=i,
     port_fraction=0.3, volume_fraction=0.2) at 900x100 and 2000x200 with
     K = 2, 3, 5, 8 (and 16 at 2000x200) and one node killed a stage, 8
     stages of 2000x200 with 15% of their nodes down, and two stagings of
     the phase-4 fleet (one node down, 5% down): each lane of one
     ``solve_multiplexed`` batch must equal a solo resident-warm solve of
     a double-built stage bit for bit, with the batch's and the solo
     solves' wall ms; one more batch under torch.profiler must make no
     host-to-device copy in its ``fleet.mux`` range;
  7. ``[slots]``: the slot manager on keyed 2000x200 stages: 12 stages
     under 8 slots (the 8 newest resident, 4 evicted with snapshots, their
     card memory freed), a warm re-admission after churn bit-identical to
     a never-evicted control, a 1-byte budget, the byte accounting;
  8. ``[seeds]``: a cold ``solve()`` of the headline fleet with each
     ``seed_impl`` (scan = K6, batched = K4, native, partitioned), then one
     node down and 5% of the nodes down with the legacy host pre-repair
     (``prerepair=True``), through ``init_assignment`` and through a
     resident-warm staging (K2 and K5 must not launch);
  9. ``[fallback]``: ``place_with_fallback(GpuSolverScheduler(), pt,
     place_kwargs={"stage": ...})`` on a 2000x200 stage made infeasible by
     eligibility (every 8th service may use only 10 nodes, all down;
     relax_order ["tier"]): feasible after relaxing "tier", in one slot;
     ``pick_scheduler`` at three sizes;
     ``[frontend]``: KDL text to the card. The fleet the reference bench's
     pipeline generates for one tenant (``generate_fleet_kdl("t0", 10000,
     seed=100, n_nodes_hint=1000, port_base=10000)`` and
     ``generate_servers_kdl(1000, seed=7)``) parsed with the native fast
     path (the CPython assembly built from ``csrc/host/``) and with
     FLEET_KDL_NATIVE=0, the two Flows equal through ``flow_to_dict``;
     ``lower_stage`` to 10,602 x 1,000; ``GpuSolverScheduler()`` cold,
     then one node and 5% of the nodes down (K4, K3 and K1 launch);
     ``explain_assignment`` of the first port row and the first colocated
     row (chosen node feasible); the same fleet as a two-file project
     loaded with FLEET_PARSE_WORKERS=2 (a fork pool after CUDA is up)
     lowering to the same tensors; every stage of ``examples/`` loaded
     with the pool, lowered and placed (production's keeps its quota,
     fallback and spread);
     ``[options]``, after ``[frontend]`` (30 s budget): the solver's
     options beside the main path. (a) Five rounds, each of a fresh pair
     of ``GpuSolverScheduler()``s on the headline fleet, each a cold place
     and three bursts (one node down, 5% down, 64 arrivals into phantom
     rows): A reschedules with ``overlap_host_work`` set to
     ``lower_stage`` of ``[frontend]``'s flow (a re-lowering of one
     fleet), B without it, the order alternating by burst and round; A
     equals B bit for bit, the callable ran once a burst,
     ``overlap_host_ms`` is in A's timings and outside its
     ``subsolve_ms``; each burst prints A's and B's wall, the re-lowering
     alone and the hidden ms (B + re-lowering - A, and B +
     ``overlap_host_ms`` - A), then each burst's median, least and
     greatest over the rounds. (b) ``solve_sharded`` cold on the sharded
     fleet over a 1x8 mesh with and without the callable (equal), and
     with ``proposals_per_step=128`` beside the default (the width
     reported). (c) ``do_repair=False`` on ``[fallback]``'s blocked
     instance through ``solve``, ``solve_multiplexed`` (2 lanes) and
     ``solve_sharded``: violations above 0 and equal to the host verify,
     0 moves, and the ``do_repair=True`` result the host repair of that
     assignment; through ``solve`` also a 2-sweep hot fixed budget
     (T = 5), whose repair must move rows and leave fewer violations than
     the unrepaired result;
     ``[cp]``: the control plane's placement path on ``[frontend]``'s
     fleet and servers. A ``Store`` of the 1,000 servers (online, with
     the KDL's capacities and labels); ``PlacementService(store)`` (the
     card) solves and commits the fleet and a second stage on the same
     servers (``generate_fleet_kdl("t1", 1000, seed=101, ...)``), then
     ``node_events`` with the busiest node the stages share down, and 50
     more nodes down, and commits what the churn placed; an
     ``AdmissionController`` on the first stage drains 64 arrivals and
     16 departures through ``step()``; ``explain`` of a port row. Each
     call prints its wall, solve and host ms (lower, inventory,
     bookkeeping) and the solver's timings with the card line. Every
     placement has 0 violations and nothing on a dead node, no server is
     booked past its capacity across the stages, the churn-fallback
     counter never moves, every source is ``gpu-anneal``, the cold solves
     launch K4, K3 and K1 and every warm call K2 or K5, and each
     admission micro-solve is a resident delta merge (no cold restage);
 10. ``[entry]``: ``fn(*args)`` of ``fleetflow_tpu_torch.entry.entry()``,
     K1 launched 32 times, the cost finite and no worse than the
     all-on-node-0 start;
 11. ``[sharded]``: the pod path on one card (every mesh position names
     the card): a cold ``solve_sharded`` of the reference bench's sharded
     child fleet (synthetic_problem(9997, 1000, seed=0, n_tenants=8,
     port_fraction=0.2, volume_fraction=0.1)) over a 1x8 mesh; the bench's
     resident leg over a 2x4 tempering mesh (a cold solve, a warm-up
     burst, 6 bursts each killing the busiest node and reviving the one
     killed two bursts before, through ``ShardedResident.apply_delta``
     and a resident-warm solve; one more under torch.profiler must make no
     host-to-device copy in its ``fleet.sharded`` range); the XL fleet
     (29997x3000) cold over a 1x8 mesh, with ``per_device_bytes`` and the
     card's peak allocation. K7 and K3 launch, no other kernel; then K3
     (cold 1x8 and XL) and K7 (all three) against their plain versions
     on these stagings, from each one's winner;
 12. ``[dryrun]``: ``entry.dryrun_multichip(8)`` on 8 positions of the
     card (K1 and K3 for the chain layout, K7 for the two sharded ones);
     ``[ranks]``, after ``[dryrun]``: 4 worker processes (this script
     with ``--ranks-worker DIR``), each a rank of a gloo process group on
     the card (``parallel.init_multihost(device="cuda:0",
     backend="gloo")``), their launches read back through
     FLEET_LAUNCH_DIR: a 2x2 tempered ``anneal_sharded`` of the sharded
     fleet across the ranks, 8 sweeps from a one-card 2x2 K7 run's
     initial state with its recorded draws, the assignment and every
     replica plane bit-equal to that run's, each sweep's event ms by
     entry point and collective; ``solve_sharded`` over the 2x2 ranks,
     cold and three warm bursts (one node down, 5% down, 64 arrivals into
     phantom rows), 0 violations, nothing on a dead node, one assignment
     on every rank, no counted upload and no host-to-device copy in a
     warm ``fleet.sharded`` range but gloo's pinned staging, each rank's
     peak allocation beside its shard's ``per_device_bytes``; at the
     headline fleet ``solve(mesh=parallel.chain_mesh(), chains=8)`` and
     ``GpuSolverScheduler(mesh=)`` cold and one node down equal to the
     one-card solves bit for bit; K7's cross-rank entry points (elect,
     apply, reduce) must launch, with K3, K4 and K1, and are held against
     their plain versions on CPU copies of every 2x2 position's inputs
     (max |err| 0), on three recorded sweeps and on the adversarial
     draws (``rank_adversarial_draws``: one service, one target node,
     all rejected, the shard's rows once each at the widest M the bind
     takes), then timed as ``anneal_ranks`` launches them (one bound
     launcher, 30 sweeps: event, device and host ms); NCCL is not
     exercised (one card); the
     phase's seconds against its 90 s budget
     (``fleetflow_tpu_torch/tools/ranks_probe.py`` runs it alone);
     ``[heal]``, after the other phases: the control plane's
     self-healing loop at ``[cp]``'s width. Both stages solved and
     committed on a fresh store, deployed on 1,000 in-process agents
     (a MockBackend and a DeployEngine each, behind an AgentRegistry), a
     FailureDetector fed heartbeats on a virtual clock and the
     Reconverger: the busiest shared node
     disconnects, then 8 seeded nodes lapse; each dead verdict's one step
     re-solves both stages on the card (K2 or K5 in each) and redeploys
     them on the survivors, every service row running on its placed
     node, nothing parked, no fallback; each burst prints the sweep,
     node_events, payload-build, fan-out, commit and record ms;
     ``[world]``, after ``[heal]``: the chaos world placing on the card.
     Every scenario of ``chaos.scenario_names()`` at seed 7 and its
     docstring sizing with ``pool_min=2`` (the eight hand-written ones at
     60x10x2, the four world ones at 200x20x4 or 200x21x4), then the
     acceptance runs ``rolling-kill-selfheal`` and ``cp-failover`` at
     1,000 services x 100 nodes x 2 stages; each run holds every
     invariant (no violation) with 0 host fallbacks and solves on the
     card; K1, K3 and K4 launch over the phase, and K2 or K5;
     ``rolling-kill-selfheal`` at its pack size run twice gives one
     digest; after the 1,000 x 100 ``cp-failover`` (three promotions,
     each on a fresh scheduler) the card's allocated memory is back
     within 64 MB of its value before the phase. One line a run (size,
     wall s, stats, heals, failovers, solves, launches by kernel, digest)
     and the phase's seconds against its 300 s budget;
     ``[wire]``, after ``[world]``: a control-plane server on a socket
     (``cp.start`` with token auth, self-heal, admission and the
     collector, placing on the card), reached by ProtocolClients: the
     [frontend] servers registered over ``server.register``,
     ``placement.solve`` of the 10,602-row fleet with a reservation and
     its commit, ``node_events`` with the busiest node down and then 50
     more, ``explain``, ``health solver.slots``, 64 arrivals through
     ``deploy.submit`` until admitted; 100 agents on the agent channel, a
     1,000-service ``deploy.execute`` onto them, the busiest agent's
     session closed and its rows healed onto the survivors; a standby
     that catches up, promotes when the server stops and solves the
     fleet on a fresh scheduler. Where ``cryptography`` imports, a server
     with its mesh CA and a master key is reached through a pinned
     client too. Fails on an RPC error, a moved request-error counter, a
     violation, a row on a dead node, a source other than
     ``gpu-anneal``, a host fallback, a deployed row not running, K1, K3,
     K4 or both of K2 and K5 not launched, or the card's memory more
     than 64 MB from before; one line an RPC with its wall ms beside the
     solver's, the heal's and the promotion's seconds, and the phase's
     seconds against its 120 s budget;
     ``[registry]``, after ``[wire]``: BASELINE config 4 built from a
     registry, at the reference bench's pipeline shape
     (bench.py:1070-1108): 8 fleetgen tenant fleets of 1,250 services as
     project directories and a fleet-registry.kdl of 1,000 generated
     servers, through ``find_registry``, ``parse_registry_file`` and
     ``aggregate_fleets`` (a FlowCache, the default loader and stage
     hash, FLEET_PARSE_WORKERS=4: a fork pool after CUDA is up) to one
     instance, placed by ``GpuSolverScheduler``; fleet t0 regenerated 17
     services short (bench.py:1191), re-aggregated through the same cache
     (one fleet-stage missing, seven hitting) and re-placed with
     ``reschedule`` on the same stage key, seeded by row name. Fails on a
     violation, a source other than ``gpu-anneal``, a solve off the
     card, a re-place not seeded by name, a warm move the edit did not
     force, a row in no node slice or in two, K4, K3 or K1 not launched,
     both of K2 and K5 not launched on the re-place, or the ``lower``
     phase gauge unset; one line a step (rows, the pool's load ms,
     ``lower_stage``'s ms, the aggregation's ms, the place ms, the
     solver's ms, the warm seed's host ms, the cache, the launches) and
     the phase's seconds against its 60 s budget;
     ``[agent]``: 100 port ``Agent``s (each on its own MockBackend) behind
     ``cp.start(ServerConfig(auth_kind="token", self_heal=True))`` on
     127.0.0.1, registering and heartbeating; [wire]'s 1,000-service
     stage deployed through ``deploy.execute``, each agent executing its
     own slice; the busiest agent stopped and its rows healed onto the
     survivors; a quadlet and a compose stage through a recording
     systemctl and compose runner; ``container.restart``,
     ``server.ping`` and the agent's ``status``. Fails on an RPC or
     command error, a moved request-error or command-error counter, a
     host fallback, a violation, a source other than ``gpu-anneal``, a
     row not running on its placed live agent or an agent holding more
     than its slice, units or a compose file other than the generators',
     K1, K3 or K4 not launched or both of K2 and K5, or the card's memory
     more than 64 MB from before; one line an RPC, the deploy's and the
     heal's seconds and the phase's seconds against its 90 s budget;
     ``[cli]``, after ``[agent]``: the operator's entry points, each on
     the card: ``fleet solve`` of [frontend]'s fleet written as a project,
     in this process and as ``python -m fleetflow_tpu_torch.cli``; the
     ``fleetflowd`` daemon started with ``python -m
     fleetflow_tpu_torch.daemon start`` (token auth, web, self-heal),
     ``fleet cp login``, ``fleet cp registry sync``, a placement and its
     commit and the busiest node down through ``CpClient``, ``fleet cp
     placement state`` and ``explain``, ``GET /metrics``, ``fleet cp
     daemon stop``; ``fleet cp registry solve`` of [registry]'s 8 fleets;
     the MCP server's ``fleet_solve`` over stdio; ``fleet chaos run``
     (``rolling-kill-selfheal``, ``diurnal-hotspot``) and ``fleet plan
     simulate`` of the plan-simulate example. Fails on a nonzero exit, a
     source other than ``gpu-anneal``, a violation, a row on a dead node,
     a solve off the card, a step without K4, K3 and K1 (the daemon's
     churn without K2 or K5), or a daemon that does not stop; one line a
     step with its wall ms, the children's and this process's launches,
     and the phase's seconds against its 120 s budget;
     ``[audit]``, after ``[cli]``: the launch contracts of the six hot
     dispatches (``fleetflow_tpu_torch/analysis/auditor.py`` over
     ``solver/contracts.py``) on the card, once at full width (the
     headline fleet staged at 10,848 x 1,000, 8 lanes of 2,000 x 200,
     the sharded fleet on a 1x8 mesh), then ``fleet audit all --strict``
     through ``cli.main.main`` in this process (exit 0), whose own audit
     at the audit tiers (the pinned golden's cases) is read back and
     must equal ``analysis/launch_contract.json``: the merges write their
     planes in place, the warm dispatches keep their seeds and make no
     upload in their profiler range, nothing is built at a later tier,
     each dispatch launches its kernels and no other. One line a
     dispatch and tier (planes written in place, uploads, downloads and
     syncs in its range, CUDA-event ms, kernels launched, the card) and
     the phase's seconds against its 45 s budget;
     ``[device]``: K4's and K3's device-only ms and device launches a
     call at both sizes (K3 also at 8 lanes), from the kernel cases of
     ``fleetflow_tpu_torch/tools/k34_profile.py`` in a fresh interpreter,
     and K7's device ms a sweep at every [k7] and [sharded] staging (the
     k7 and k7-sharded cases of ``tools/k67_profile.py``), and K5's
     device ms by entry point at mini tiers 256-4096 of the phase-4 fleet
     (``tools/k5_profile.py``'s stage and commit cases);
     ``[phases]``: K1's and K2's phase split from their cycle stamps (the
     phases case of ``fleetflow_tpu_torch/tools/k12_profile.py``, its own
     -DK1_PHASES -DK2_PHASES build, in a fresh interpreter), and K6's and
     K7's (``tools/k67_profile.py``, -DK6_PHASES -DK7_PHASES);
 13. print the per-kernel JSON line (launches also by fleet size; K1 and
     K2 with each size's ms and their phases, K6 with its microseconds a
     step, K6 and K7 with their phases, K7 with each staging's device
     ms, K7's three cross-rank entry points with the [ranks] workers'
     launches), the
     card line, and last
     ``{"ok": true, "device": {...}}``.

Every solve of phases 3 to 8 and 11, and phase 9's relaxed re-solve, must have
0 violations (checked again by
the host numpy verifier), 0 violations before the host repair backstop, no
host repair move and no service on a dead node; a localized solve may move
no row outside the churn's constraint closure. Every kernel of a phase's
path must have been launched by that phase, the launch counts set to 0
just before it and read just after. A warm dispatch traced for its
host-to-device copies is traced after a probe upload; a trace that missed
the probe proves nothing, and another burst is traced (at most 3).

``--profile`` drives phases 3 and 4 once more under torch.profiler and
prints the device time by kernel and the device busy share of the solves,
then 8 stages of 2000x200 solved one by one and in one batch.

It exits non-zero without printing a result when CUDA is absent or the
package is not beside it.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import importlib
import json
import logging
import math
import os
import random
import re
import socket
import statistics
import subprocess
import sys
import sysconfig
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace
from typing import Optional

N_SERVICES, N_NODES = 10_000, 1_000
TENANT_ROWS = 200          # the burst pattern's arriving/departing stage
ARRIVALS = 64              # id-free services arriving into phantom rows
ROLLING_KILLS = 8
BURSTS = ("kill1", "arrive", "kill3", "depart", "arrive", "kill3")
KERNEL_NAMES = ("k1_sweep", "k2_prerepair", "k3_rebuild", "k4_greedy",
                "k5_subsolve", "k6_greedy_scan", "k7_sharded_sweep",
                "k7_rank_elect", "k7_rank_apply", "k7_rank_reduce")
# the sharded phases' fleets: the reference bench's sharded child (ragged,
# so it pads) and its XL record (docs/profiles/r5-xl-sharded.md)
SHARDED_SHAPE = (9_997, 1_000)
XL_SHAPE = (29_997, 3_000)
SHARDED_BURSTS = 6
# K1 is timed at the anneal's hot start and at its floor temperature
K1_TEMPS = (1.0, 1e-3)
K2_HEAD = dict(name="k2_prerepair", route="cuda",
               source="fleetflow_tpu_torch/csrc/k2_prerepair.cu",
               replaces="fleetflow_tpu/solver/anneal.py:133", library_ms=None)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores (the kernels do float32/int32 work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# float planes: the plain versions sum with atomics on the card (another
# order than the kernels' index order), so loads agree to float32 rounding
LOAD_RTOL = 1e-5
# warm dispatches traced until one trace sees a probe's upload
H2D_TRIES = 3
# [device] tool runs until torch.profiler has recorded each case's kernels
DEVICE_TRIES = 3


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


@contextmanager
def as_deployed(torch):
    """Timing as the solver runs: without the deterministic algorithms the
    plain-version checks turn on (under them every torch.empty launches a
    fill of its memory, which no solve pays)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=True)


def cuda_ms(torch, fn, setup=None, reps: int = 5, warmup: int = 1) -> float:
    """Median CUDA-event time of fn(*setup()) over `reps` runs."""
    with as_deployed(torch):
        return _cuda_ms(torch, fn, setup, reps, warmup)


def _cuda_ms(torch, fn, setup, reps: int, warmup: int) -> float:
    times = []
    for i in range(warmup + reps):
        args = setup() if setup is not None else ()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def max_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def sweep_prop_bytes(K: int, Kc: int, pref: bool = False) -> float:
    """Bytes one proposal of a sweep (K1, K7) must move: its service's
    demand, id rows and assignment, two eligibility words (and two
    preferences), the two node rows' load, capacity, occupancy, validity
    and domain read once, the moved rows written once. A sweep does ~120
    float32 operations a proposal."""
    return (12 + 4 + 12 + 4 * K + 4.0 * Kc + 2 * 4 + 2 + 2 * 12 + 2 * 12
            + 2 * 4 * K + 2 * 4.0 * Kc + (8 if pref else 0))


def k2_cost(prob, moves: int, lanes: int = 1) -> dict:
    """The bytes and operations K2 must spend on `lanes` lanes of `prob`
    making `moves` moves in all: each lane's assignment read and written,
    its load and capacity read; per move, all N nodes scored (fit,
    conflicts, utilization: ~12 operations and a conflict column read a
    node) against the service's eligibility row and demand, and the two
    touched rows written."""
    S, N = prob.S, prob.N
    W = (N + 31) // 32
    Ks = float((prob.conflict_ids >= 0).sum(-1).float().mean())
    return dict(ops=moves * N * (12.0 + Ks),
                bytes=lanes * (4.0 * (2 * S) + 4.0 * 2 * N * 3 + N)
                + moves * (4.0 * (W + 3 + N * Ks) + 2 * 12 + 8.0 * Ks))


def k3_bytes(prob, C: int, stats: bool = True) -> float:
    """Bytes a K3 rebuild of C chains must move: the assignments, demand,
    conflict and coloc ids and the node domains read, each chain's planes
    written; with `stats`, also the capacity, the validity and one
    eligibility word per (chain, service) read and the stats written."""
    S, N = prob.S, prob.N
    K, Kc = prob.conflict_ids.shape[1], prob.coloc_ids.shape[1]
    planes = N * 3 + N * prob.G + N * max(prob.Gc, 1) + prob.T
    out = (4.0 * (C * S + S * 3 + S * K + S * Kc + N)
           + 4.0 * C * planes)
    if stats:
        out += 4.0 * (N * 3 + C * S) + N + 4.0 * C * 5
    return out


def size_rec(recs: dict, name: str, head: dict, rec: dict) -> None:
    """Record a kernel measured at one size: the first size fills the
    kernel line's own fields, and every size goes under its `sizes`, with
    its bound."""
    bound, by = bound_of(rec["bytes"], rec["ops"])
    if name not in recs:
        recs[name] = dict(head, **rec)
        recs[name].pop("size")
    recs[name].setdefault("sizes", []).append(dict(
        {k: v for k, v in rec.items() if k not in ("bytes", "ops")},
        bound_ms=bound, bound_by=by))


def k3_against_plain(torch, kernels, prob, a, size: str, recs: dict,
                     rows: str):
    """K3 with the stats against k3_rebuild_plain on the (C, S)
    assignments `a` (`rows` names them) of the staging `prob`: integer
    planes and stats equal, the load within LOAD_RTOL with its max |err|
    printed; the CUDA-event ms of both and of index_add_ (the load alone)
    recorded under the kernel line's `sizes` as `size`. Returns the
    kernel's outputs."""
    was = torch.are_deterministic_algorithms_enabled()
    # the plain version's index_add_ sums in index order under the
    # deterministic algorithms, which is the kernel's order
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out_k = kernels.k3_rebuild(prob, a, with_stats=True)
        out_p = kernels.k3_rebuild_plain(prob, a, with_stats=True)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was, warn_only=True)
    for name, x, y in zip(("used", "coloc", "topo", "stats"), out_k[1:],
                          out_p[1:]):
        if not torch.equal(x, y):
            raise AssertionError(f"K3 at {size}: {name} differs")
    err = max_err(torch, out_k[0], out_p[0])
    if not torch.allclose(out_k[0], out_p[0], rtol=LOAD_RTOL, atol=0):
        raise AssertionError(f"K3 at {size}: load differs by {err}")
    ms = cuda_ms(torch, lambda: kernels.k3_rebuild(prob, a, with_stats=True),
                 reps=10)
    plain = cuda_ms(torch, lambda: kernels.k3_rebuild_plain(
        prob, a, with_stats=True))
    C = a.shape[0]
    flat = a.long().reshape(-1)
    dem = prob.demand.repeat(C, 1)
    lib = cuda_ms(torch, lambda: torch.zeros(
        (prob.N, 3), device=a.device).index_add_(0, flat, dem))
    size_rec(recs, "k3_rebuild", dict(
        name="k3_rebuild", route="cuda",
        source="fleetflow_tpu_torch/csrc/k3_rebuild.cu",
        replaces="fleetflow_tpu/solver/anneal.py:88"),
        dict(size=size, padded_S=prob.S, max_abs_err=err, ms=ms,
             plain_ms=plain, library_ms=lib, ops=0.0,
             bytes=k3_bytes(prob, C)))
    print(f"[k3_rebuild] {size}: equal integer planes and stats ({rows} "
          f"{out_k[4].tolist()}), load max |err| {err:.3g}; kernel "
          f"{ms:.3f} ms, plain {plain:.3f} ms, index_add_ {lib:.3f} ms",
          flush=True)
    return out_k


# k34_profile.py's cases: (kernel, size record) each fills
K34_CASES = {"k4 10000x1000": ("k4_greedy", "10000x1000"),
             "k4 2000x200": ("k4_greedy", "2000x200"),
             "k3 10000x1000 C=2": ("k3_rebuild", "10000x1000"),
             "k3 2000x200 C=2": ("k3_rebuild", "2000x200")}


def measure_device(recs: dict) -> None:
    """[device]: the device-only ms and device launches a call of K4 and
    K3 at 10k x 1k and 2000x200 (and K3's 8 lanes), from the kernel cases
    of fleetflow_tpu_torch/tools/k34_profile.py run on this checkout in a
    fresh interpreter (torch.profiler late in this process has lost
    kernel records). Each kernel's size records get device_ms and
    device_launches (each kernel's count a call, rounded: the profiler
    can drop a record); every case goes under the kernel's `device`."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "fleetflow_tpu_torch", "tools",
                        "k34_profile.py")
    run = subprocess.run([sys.executable, tool, "--cases", "k4,k3,k3-lanes",
                          "--child", root],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"[device] k34_profile failed:\n"
                             f"{run.stderr[-3000:]}")
    for line in run.stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        launches = sum(round(n) for _ms, n in row["by_name"].values())
        case = dict(case=row["case"], ms=row["event_ms_median"],
                    device_ms=row["device_ms"], device_launches=launches)
        name = "k4_greedy" if row["case"].startswith("k4") else "k3_rebuild"
        recs[name].setdefault("device", []).append(case)
        if row["case"] in K34_CASES:
            size = K34_CASES[row["case"]][1]
            for rec in recs[name]["sizes"]:
                if rec["size"] == size:
                    rec["device_ms"] = case["device_ms"]
                    rec["device_launches"] = launches
            if size == recs[name]["sizes"][0]["size"]:
                recs[name]["device_ms"] = case["device_ms"]
                recs[name]["device_launches"] = launches
        print(f"[device] {row['case']}: {case['device_ms']:.4f} ms of "
              f"device time, {launches} device launches a call; event "
              f"{case['ms']:.4f} ms", flush=True)


def measure_k5_device(recs: dict) -> None:
    """[device]: K5's device ms by entry point at mini tiers 256, 512, 1024
    and 4096 of the [default] fleet (the stage and commit cases of
    fleetflow_tpu_torch/tools/k5_profile.py on this checkout, in a fresh
    interpreter): each row under the kernel's `device`, and the kernel
    line's device ms (stage + commit) and each entry's at the tier nearest
    the kill3 plan's. A run in which the profiler recorded no kernel time
    for an entry at that tier (it lost the records) is repeated, at most
    DEVICE_TRIES runs."""
    k5 = recs["k5_subsolve"]
    for _attempt in range(DEVICE_TRIES):
        by_case = {}
        for row in tool_rows("k5_profile.py", "stage,commit", "k5_profile"):
            row.pop("tree")
            by_case[row["case"]] = row
            print(f"[device] k5 {row['case']}: kernel "
                  f"{row['kernel_device_ms']:.4f} ms of device time "
                  f"({row['device_ms']:.4f} with its copies, "
                  f"{row['device_ops_per_call']:.0f} device operations a "
                  f"call), event {row['event_ms_median']:.4f} ms, host "
                  f"{row['host_ms_median']:.4f} ms"
                  + (f", {row['uploads']} upload of {row['upload_bytes']} "
                     f"bytes, plan_active {row['plan_ms_median']:.3f} ms"
                     if "uploads" in row else ""), flush=True)
        tiers = sorted({int(c.rpartition("=")[2]) for c in by_case})
        if not tiers:
            raise AssertionError("[device] k5_profile printed no rows")
        tier = min(tiers, key=lambda t: abs(t - k5["tier"]))
        rows = [by_case.get(f"{e} tier={tier}") for e in ("stage", "commit")]
        if all(r is not None and r["kernel_device_ms"] for r in rows):
            break
    else:
        raise AssertionError(f"[device] k5 entries at tier {tier} without "
                             f"device time after {DEVICE_TRIES} runs")
    k5["device"] = list(by_case.values())
    for entry, row in zip(("stage", "commit"), rows):
        k5["entries"][entry]["device_ms"] = row["kernel_device_ms"]
    k5["device_ms"] = sum(e["device_ms"] for e in k5["entries"].values())
    k5["device_tier"] = tier


def measure_phases(recs: dict) -> None:
    """[phases]: K1's and K2's phase split from their own cycle stamps:
    the phases case of fleetflow_tpu_torch/tools/k12_profile.py on this
    checkout (its kernels built with -DK1_PHASES -DK2_PHASES) in a fresh
    interpreter, each row under its kernel's `phases`."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "fleetflow_tpu_torch", "tools",
                        "k12_profile.py")
    run = subprocess.run([sys.executable, tool, "--cases", "phases",
                          "--phases", root],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"[phases] k12_profile failed:\n"
                             f"{run.stderr[-3000:]}")
    rows = [json.loads(x) for x in run.stdout.splitlines()
            if x.startswith("{")]
    for row in rows:
        if row.get("stamps") is False:
            raise AssertionError("[phases] the kernels have no stamps")
        name = "k1_sweep" if row["case"].startswith("phases k1") else \
            "k2_prerepair"
        row.pop("tree")
        recs[name].setdefault("phases", []).append(row)
        print(f"[phases] {json.dumps(row)}", flush=True)
    if not all(recs[k].get("phases") for k in ("k1_sweep", "k2_prerepair")):
        raise AssertionError(f"[phases] rows missing: {run.stdout[-2000:]}")


def tool_rows(tool: str, cases: str, tag: str) -> list:
    """The JSON rows of `fleetflow_tpu_torch/tools/<tool> --cases <cases>
    --child <this checkout>`, run in a fresh interpreter."""
    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, os.path.join(root, "fleetflow_tpu_torch", "tools",
                                      tool), "--cases", cases, "--child",
         root], capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"[device] {tag} failed:\n"
                             f"{run.stderr[-3000:]}")
    return [json.loads(x) for x in run.stdout.splitlines()
            if x.startswith("{")]


def measure_k7_device(recs: dict) -> None:
    """[device]: K7's device ms a sweep at every [k7] and [sharded]
    staging (the resident 2x4 one after a cold solve and one burst), at
    the warm schedule's t0 and t1, from the k7 and k7-sharded cases of
    fleetflow_tpu_torch/tools/k67_profile.py on this checkout in a fresh
    interpreter (torch.profiler in this process would disturb the later
    phases' traces). Each row goes under the kernel's `device` and the
    t0 device ms into its layout. A staging whose sweeps the profiler
    recorded no device work for (it has lost a case's records) is
    measured again in a new run of the tool, at most DEVICE_TRIES runs."""
    k7 = recs["k7_sharded_sweep"]
    for _attempt in range(DEVICE_TRIES):
        for row in tool_rows("k67_profile.py", "k7,k7-sharded", "k67_profile"):
            case = dict(case=row["case"], ms=row["event_ms_median"],
                        device_ms=row["device_ms"],
                        host_ms=row["host_ms_median"],
                        device_launches=round(row["device_ops_per_call"]),
                        applied=row["applied"])
            layout, _, temp = row["case"][len("k7 "):].rpartition(" T=")
            print(f"[device] {row['case']}: {case['device_ms']:.4f} ms of "
                  f"device time, event {case['ms']:.4f} ms, host "
                  f"{case['host_ms']:.4f} ms, {case['device_launches']} "
                  f"device launch a sweep", flush=True)
            if not case["device_ms"]:
                continue            # the profiler lost this case's records
            k7.setdefault("device", []).append(case)
            if (temp == "t0" and layout in k7["layouts"]
                    and not k7["layouts"][layout]["device_ms"]):
                k7["layouts"][layout]["device_ms"] = case["device_ms"]
        if all(v["device_ms"] for v in k7["layouts"].values()):
            break
    missing = [k for k, v in k7["layouts"].items() if not v["device_ms"]]
    if missing:
        raise AssertionError(f"[device] K7 stagings without device time "
                             f"after {DEVICE_TRIES} runs: {missing}")
    k7["device_ms"] = k7["layouts"]["1x8"]["device_ms"]


def measure_k67_phases(recs: dict) -> None:
    """[phases]: K6's and K7's phase split from their own cycle stamps:
    the phases case of fleetflow_tpu_torch/tools/k67_profile.py on this
    checkout (its kernels built with -DK6_PHASES -DK7_PHASES) in a fresh
    interpreter, each row under its kernel's `phases` (K6 at every
    [k6_scan] size, K7 at the [k7] stagings at both temperatures)."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "fleetflow_tpu_torch", "tools",
                        "k67_profile.py")
    run = subprocess.run([sys.executable, tool, "--cases", "phases",
                          "--phases", root],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"[phases] k67_profile failed:\n"
                             f"{run.stderr[-3000:]}")
    rows = [json.loads(x) for x in run.stdout.splitlines()
            if x.startswith("{")]
    for row in rows:
        if row.get("stamps") is False:
            raise AssertionError("[phases] the kernels have no stamps")
        name = "k6_greedy_scan" if row["case"].startswith("phases k6") else \
            "k7_sharded_sweep"
        row.pop("tree")
        recs[name].setdefault("phases", []).append(row)
        print(f"[phases] {json.dumps(row)}", flush=True)
    if not all(recs[k].get("phases")
               for k in ("k6_greedy_scan", "k7_sharded_sweep")):
        raise AssertionError(f"[phases] rows missing: {run.stdout[-2000:]}")


def check_kernels(torch, np, pkg, dev):
    """Phase 2: every kernel against its plain version at the slice size
    (K4 and K3 also on the 2000x200 mux tier). Returns {kernel: record}
    with the measured times and errors."""
    anneal, kernels, greedy, problem, lower, buckets = pkg
    pt = lower.synthetic_problem(N_SERVICES, N_NODES, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    prob = problem.prepare_problem(pt, dev)
    S, N = prob.S, prob.N
    K = prob.conflict_ids.shape[1]
    recs = {}
    # the plain versions' index_add_ sums in index order under the
    # deterministic algorithms, which is the kernels' order
    torch.use_deterministic_algorithms(True, warn_only=True)

    # K4 and K3 at the headline size (exact shapes) and on the 2000x200
    # mux tier (bucketed staging, phantom rows last in the order)
    stage2, _ = buckets.stage_problem_tiers(mux_fleets(lower)(2000, 200, 0),
                                            device=dev)
    pt2 = mux_fleets(lower)(2000, 200, 0)
    sizes = ((f"{S}x{N}", pt, prob), ("2000x200", pt2, stage2))
    seeds = {}
    for size, pt_s, prob_s in sizes:
        order = torch.tensor(np.concatenate([
            greedy.placement_order(pt_s.demand, pt_s.dep_depth,
                                   problem.unify_conflict_ids(pt_s)),
            np.arange(pt_s.S, prob_s.S, dtype=np.int32)]),
            dtype=torch.int32, device=dev)
        seed_k = greedy.greedy_place_batched(prob_s, order)
        seed_p = greedy.greedy_place_batched_plain(prob_s, order)
        torch.cuda.synchronize()
        if not torch.equal(seed_k, seed_p):
            raise AssertionError(f"K4 at {size}: assignment differs in "
                                 f"{int((seed_k != seed_p).sum())} services")
        seeds[size] = seed_k
        ms = cuda_ms(torch, lambda: greedy.greedy_place_batched(prob_s,
                                                               order))
        plain = cuda_ms(torch, lambda: greedy.greedy_place_batched_plain(
            prob_s, order), reps=3)
        Ss, Ns = prob_s.S, prob_s.N
        Ws = prob_s.eligible.shape[1]
        Ks = prob_s.conflict_ids.shape[1]
        # the least work: one scoring pass over every (service, node) pair,
        # ~30 float32 operations each (3 adds, 3 compares, 3 divides, 3
        # squares, 2 adds, 3 overflow terms, the fallback score)
        rec = dict(size=size, padded_S=Ss, max_abs_err=0.0, ms=ms,
                   plain_ms=plain, ops=Ss * Ns * 30.0,
                   bytes=4.0 * (Ss + Ss * 3 + Ns * 3 + Ss * Ks + Ss * Ws
                                + Ss) + Ns)
        size_rec(recs, "k4_greedy", dict(
            name="k4_greedy", route="cuda",
            source="fleetflow_tpu_torch/csrc/k4_greedy.cu",
            replaces="fleetflow_tpu/solver/greedy.py:193", library_ms=None),
            rec)
        print(f"[k4_greedy] {size}: equal assignments; kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms", flush=True)

    # K3: rebuild + exact stats on the seed and on a perturbed assignment
    rng = np.random.default_rng(0)
    boths = {}
    for size, pt_s, prob_s in sizes:
        Ss = prob_s.S
        pert = seeds[size].clone()
        heavy = torch.tensor(rng.choice(Ss, Ss // 3, replace=False),
                             device=dev)
        pert[heavy] = torch.tensor(rng.integers(0, 10, heavy.numel()),
                                   dtype=torch.int32, device=dev)
        ports = torch.tensor(np.flatnonzero((pt_s.port_ids >= 0).any(1)),
                             device=dev)
        pert[ports] = 0
        both = boths[size] = torch.stack([seeds[size], pert])
        out_k = k3_against_plain(torch, kernels, prob_s, both, size, recs,
                                 "seed, perturbed")
        if float(out_k[4][1, 4]) == 0:
            raise AssertionError(f"K3 at {size}: the perturbed assignment "
                                 f"shows no violation")
    both, seed_k = boths[f"{S}x{N}"], seeds[f"{S}x{N}"]
    Kc = prob.coloc_ids.shape[1]

    # K1: 8 sweeps from fixed proposals, hot and cold, and cold again with
    # the warm path's stickiness to the seed (what a reschedule runs)
    M = anneal.default_proposals_per_step(S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    base = anneal.chain_states_from_assignment(prob, both)
    draws = [anneal.draw_proposals(prob, base, gen, M) for _ in range(8)]
    sticky = dataclasses.replace(prob, sticky_prev=seed_k, sticky_w=0.5)
    k1_err = 0.0
    applied_total = 0
    for label, p_k1, temp in (("T=1", prob, 1.0), ("T=1e-3", prob, 1e-3),
                              ("sticky T=1e-3", sticky, 1e-3)):
        st_k, st_p = base.clone(), base.clone()
        for s_idx, b_idx, u in draws:
            _, acc_k = anneal.batched_step_apply(p_k1, st_k, s_idx, b_idx, u,
                                                 temp)
            _, acc_p = anneal.batched_step_plain(p_k1, st_p, s_idx, b_idx, u,
                                                 temp)
            if not torch.equal(acc_k, acc_p):
                raise AssertionError(f"K1 applied counts differ at {label}")
            applied_total += int(acc_k.sum())
        torch.cuda.synchronize()
        for name in ("assignment", "used", "coloc", "topo"):
            if not torch.equal(getattr(st_k, name), getattr(st_p, name)):
                raise AssertionError(f"K1 {name} differs at {label}")
        k1_err = max(k1_err, max_err(torch, st_k.load, st_p.load))
        if not torch.allclose(st_k.load, st_p.load, rtol=LOAD_RTOL, atol=0):
            raise AssertionError(f"K1 load differs by {k1_err} at {label}")
    if applied_total == 0:
        raise AssertionError("K1 applied no move in 24 sweeps")
    s_idx, b_idx, u = draws[0]
    per_prop = sweep_prop_bytes(K, Kc)
    for temp in K1_TEMPS:
        # a sweep as the anneal loop launches it: K1 bound once a call
        ms = cuda_ms(torch, lambda sweep: sweep(s_idx, b_idx, u, [temp]),
                     setup=lambda: (anneal.sweep_launcher(
                         prob, base.clone(), M),), reps=20)
        plain = cuda_ms(torch, lambda st: anneal.batched_step_plain(
            prob, st, s_idx, b_idx, u, temp), setup=lambda: (base.clone(),))
        size_rec(recs, "k1_sweep", dict(
            name="k1_sweep", route="cuda",
            source="fleetflow_tpu_torch/csrc/k1_sweep.cu",
            replaces="fleetflow_tpu/solver/anneal.py:417", library_ms=None),
            dict(size=f"{S}x{N} T={temp:g}", max_abs_err=k1_err, ms=ms,
                 plain_ms=plain, ops=2 * M * 120.0,
                 bytes=2 * M * per_prop + 2 * 4.0))
        print(f"[k1_sweep] 3x8 sweeps x {M} proposals equal "
              f"({applied_total} moves applied), load max |err| "
              f"{k1_err:.3g}; at T={temp:g} kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms", flush=True)

    # K2: the fused pre-repair after 20 nodes are invalidated
    busiest = torch.bincount(seed_k.long(), minlength=N).argsort(
        descending=True)[:20]
    valid = prob.node_valid.clone()
    valid[busiest] = False
    dead_prob = dataclasses.replace(prob, node_valid=valid)
    st0 = anneal.chain_states_from_assignment(dead_prob, seed_k)
    stranded = int((~valid[seed_k.long()]).sum())
    st_k, st_p = st0.clone(), st0.clone()
    _, mv_k = anneal.prerepair_state_counted(dead_prob, st_k, 256)
    _, mv_p = anneal.prerepair_plain(dead_prob, st_p, 256)
    torch.cuda.synchronize()
    if not torch.equal(mv_k, mv_p):
        raise AssertionError(f"K2 moves {mv_k.tolist()} != {mv_p.tolist()}")
    for name in ("assignment", "used", "coloc", "topo"):
        if not torch.equal(getattr(st_k, name), getattr(st_p, name)):
            raise AssertionError(f"K2 {name} differs")
    err = max_err(torch, st_k.load, st_p.load)
    if err != 0.0:
        raise AssertionError(f"K2 load differs by {err}")
    moves = int(mv_k[0])
    left = int((~valid[st_k.assignment.long()]).sum())
    # every applied move takes one stranded service to a live node; the
    # budget of 256 moves may leave the rest for the anneal
    if moves == 0 or left != stranded - moves:
        raise AssertionError(f"K2: {stranded} stranded, {moves} moves, "
                             f"{left} left on dead nodes")
    ms = cuda_ms(torch, lambda st: anneal.prerepair_state_counted(
        dead_prob, st, 256), setup=lambda: (st0.clone(),))
    plain = cuda_ms(torch, lambda st: anneal.prerepair_plain(
        dead_prob, st, 256), setup=lambda: (st0.clone(),), reps=3)
    iters = min(stranded, 256)
    size_rec(recs, "k2_prerepair", K2_HEAD, dict(
        size=f"{S}x{N}", max_abs_err=err, ms=ms, plain_ms=plain,
        moves=moves, iterations=iters, us_per_iteration=ms * 1e3 / iters,
        **k2_cost(prob, moves)))
    print(f"[k2_prerepair] {stranded} services stranded on 20 dead nodes, "
          f"{moves} moves, {left} left, equal state; kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.2f} us an iteration), plain {plain:.3f} ms",
          flush=True)
    torch.use_deterministic_algorithms(False)
    return recs


def drive_main_path(np, pt, sched, ProblemDelta, record) -> None:
    """Cold place of the fleet `pt`, then three warm reschedules: one node
    down, 5% of the nodes down, a capacity refresh (±2%). Returns the fleet
    as the last reschedule left it."""
    record("cold", sched.place(pt), pt)
    first = sched.last_result.assignment
    rng = np.random.default_rng(0)
    valid = pt.node_valid.copy()
    valid[int(np.bincount(first, minlength=pt.N).argmax())] = False
    pt = dataclasses.replace(pt, node_valid=valid.copy())
    record("warm_one_node_down",
           sched.reschedule(pt, delta=ProblemDelta(node_valid=valid.copy())),
           pt)
    alive = np.flatnonzero(valid)
    valid[rng.choice(alive, int(0.05 * pt.N), replace=False)] = False
    pt = dataclasses.replace(pt, node_valid=valid.copy())
    record("warm_5pct_nodes_down",
           sched.reschedule(pt, delta=ProblemDelta(node_valid=valid.copy())),
           pt)
    cap = (pt.capacity * rng.uniform(0.98, 1.02, pt.capacity.shape)
           ).astype(np.float32)
    pt = dataclasses.replace(pt, capacity=cap)
    record("warm_capacity_refresh",
           sched.reschedule(pt, delta=ProblemDelta(node_valid=valid.copy(),
                                                   capacity=cap)), pt)
    return pt


@contextmanager
def env_set(**values):
    """Environment variables set (None: unset) around the block, the
    previous values restored."""
    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def subsolve_off():
    """FLEET_SUBSOLVE=0 around the block, the previous value restored."""
    return env_set(FLEET_SUBSOLVE="0")


def make_record(sched, verify, _ext, dev_name: str, tag: str,
                echo: bool = True):
    """The per-solve check and report line of a phase: every solve must be
    feasible (host verify agrees), need no host repair, leave nothing on a
    dead node and run on the card. Returns record(label, placement, pt,
    **extra) -> the row (printed when `echo`)."""
    seen = dict(_ext.LAUNCHES)

    def record(label, placement, pt_now, **extra):
        res = sched.last_result
        launched = {k: v - seen.get(k, 0) for k, v in _ext.LAUNCHES.items()}
        seen.update(_ext.LAUNCHES)
        host = verify(pt_now, placement.raw)
        on_dead = int((~pt_now.node_valid[placement.raw]).sum())
        if placement.violations != 0 or host["total"] != 0 or on_dead:
            raise AssertionError(f"{label}: violations {placement.violations}"
                                 f", host {host}, on dead nodes {on_dead}")
        # the card did the work: the host repair backstop was not needed
        if res.pre_repair_violations != 0 or res.moves_repaired != 0:
            raise AssertionError(
                f"{label}: the device solve left {res.pre_repair_violations}"
                f" violations, {res.moves_repaired} host repair moves")
        if res.device != dev_name:
            raise AssertionError(f"{label} solved on {res.device}")
        tel = res.telemetry or {}
        row = dict(solve=label, ms=round(placement.solve_ms, 3),
                   sweeps=res.steps,
                   prerepair_moves=tel.get("prerepair_moves"),
                   pre_repair_violations=res.pre_repair_violations,
                   warm_h2d_copies=res.warm_h2d_copies,
                   soft=round(res.soft, 6), **extra, launches=launched,
                   timings_ms={k: round(v, 3)
                               for k, v in res.timings_ms.items()})
        if echo:
            print(f"[{tag}] {json.dumps(row)}", flush=True)
        return row

    return record


# main-path launches by the fleet size they ran at: each phase tallies
# its counts under the size of the fleet it solved
BY_SIZE: dict = {}


def size_label(S: int, N: int) -> str:
    return "10k" if 9_000 <= S < 12_000 else f"{S}x{N}"


def tally_size(_ext, S: int, N: int, since: Optional[dict] = None) -> dict:
    """Add the launches since the counts `since` (since they were zeroed
    when None) to the tally of the S x N fleet. Returns the counts now."""
    return tally_label(_ext, size_label(S, N), since)


def tally_label(_ext, label: str, since: Optional[dict] = None) -> dict:
    """tally_size under `label` (a phase that ran several fleets)."""
    now = dict(_ext.LAUNCHES)
    tally = BY_SIZE.setdefault(label, {})
    for k in KERNEL_NAMES:
        tally[k] = tally.get(k, 0) + now[k] - (since or {}).get(k, 0)
    return now


def read_launches(torch, _ext, tag: str, path: tuple, off: tuple = (),
                  size: Optional[tuple] = None):
    """The phase's launch counts: every kernel of its path launched, none
    of `off` (nor K7, the sharded sweep, unless the path has it). With
    `size` (S, N), the phase ran at that fleet size alone, and its counts
    are tallied there."""
    torch.cuda.synchronize()
    if "k7_sharded_sweep" not in path:
        off = tuple(off) + ("k7_sharded_sweep",)
    launches = dict(_ext.LAUNCHES)
    if any(launches[k] == 0 for k in path) or any(launches[k] for k in off):
        raise AssertionError(f"[{tag}] launches {launches}: expected all of "
                             f"{path}, none of {off}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    if size is not None:
        tally_size(_ext, *size)
    return launches


def run_main_path(torch, np, pkg_main, pt, dev_name):
    """Phase 3: the unbucketed scheduler without the sub-solve, cold then
    three warm reschedules. Returns the launch counts of the run."""
    GpuSolverScheduler, ProblemDelta, verify, _ext = pkg_main[:4]
    with subsolve_off():
        sched = GpuSolverScheduler(bucket=False)
        torch.cuda.synchronize()
        _ext.reset_launches()
        record = make_record(sched, verify, _ext, dev_name, "main")
        pt = drive_main_path(np, pt, sched, ProblemDelta, record)
        launches = read_launches(torch, _ext, "main", KERNEL_NAMES[:4],
                                 off=("k5_subsolve", "k6_greedy_scan"),
                                 size=(pt.S, pt.N))
        warm_h2d_check(torch, np, sched, pt, ProblemDelta, record)
    return launches


def auditor():
    """The port's launch auditor (fleetflow_tpu_torch/analysis/auditor.py),
    which holds the torch.profiler helpers every no-upload check here
    shares: PROBES, h2d_in_range, host_traffic_in_range, profiled and
    probe_seen."""
    from fleetflow_tpu_torch.analysis import auditor as mod
    return mod


def trace_times(prof, range_name: str) -> dict:
    """Where a trace's records lie, in µs from its start: the probes' and
    `range_name`'s host ranges, the first device record, and each
    host-to-device copy's device record."""
    host = {n: [round(e.time_range.start, 1) for e in prof.events()
                if e.name == n and str(e.device_type).endswith("CPU")]
            for n in auditor().PROBES + (range_name,)}
    device = [e for e in prof.events()
              if not str(e.device_type).endswith("CPU")]
    return dict(host=host, device_records=len(device),
                first_device=round(min((e.time_range.start
                                        for e in device), default=-1), 1),
                h2d_device=[round(e.time_range.start, 1) for e in device
                            if "HtoD" in e.name][:6])


def check_no_h2d(prof, range_name: str, tag: str) -> None:
    """The card made no host-to-device copy in the `range_name` range (a
    warm dispatch), and a probe's upload was seen (probe_seen)."""
    seen = auditor().probe_seen(prof, range_name)
    warm = auditor().h2d_in_range(prof, range_name)
    if seen is None:
        raise AssertionError(f"the host-to-device count missed the probes' "
                             f"uploads: {trace_times(prof, range_name)}")
    if warm[0] != 1 or warm[1] == 0:
        raise AssertionError(f"no {range_name} dispatch traced: {warm}")
    if warm[2]:
        raise AssertionError(f"host-to-device copies in {range_name}: "
                             f"{warm[2]}")
    print(f"[{tag}] {range_name} under torch.profiler: {warm[1]} device "
          f"operations, 0 host-to-device copies; the {seen[0]} upload "
          f"showed {len(seen[1][2])}: {seen[1][2]}; "
          f"{json.dumps(trace_times(prof, range_name))}", flush=True)


def no_h2d_in_dispatch(attempt, range_name: str, tag: str,
                       tries: int = H2D_TRIES) -> None:
    """check_no_h2d on a warm dispatch traced by `attempt(i)` (a fresh
    dispatch under profiled() each call, its contract checked by the
    caller; returns the profiler). A trace in which no probe was seen
    (probe_seen) cannot show that the dispatch made no copy: the profiler
    lost a copy's device record. Then the next attempt (another burst) is
    traced, up to `tries`; the run fails if none saw a probe."""
    for i in range(tries):
        prof = attempt(i)
        if auditor().probe_seen(prof, range_name) is not None:
            check_no_h2d(prof, range_name, tag)
            return
        warm = auditor().h2d_in_range(prof, range_name)
        print(f"[{tag}] trace {i + 1} of {tries} missed the probes' "
              f"uploads ({[auditor().h2d_in_range(prof, p)
                           for p in auditor().PROBES]}; "
              f"{range_name}: {warm[0]} ranges, {warm[1]} device "
              f"operations, {len(warm[2])} copies; "
              f"{json.dumps(trace_times(prof, range_name))}); another "
              f"dispatch", flush=True)
    raise AssertionError(f"[{tag}] the host-to-device count missed the "
                         f"probes' uploads in {tries} traces")


def warm_h2d_check(torch, np, sched, pt, ProblemDelta, record) -> None:
    """One more warm reschedule (the busiest live node down) under
    torch.profiler: the card must make no host-to-device copy inside the
    warm dispatch, the solve's refine range."""
    from fleetflow_tpu_torch.solver.api import REFINE_RANGE

    def attempt(i):
        nonlocal pt
        valid = pt.node_valid.copy()
        load = np.bincount(sched.last_result.assignment, minlength=pt.N)
        valid[int(np.argmax(np.where(valid, load, -1)))] = False
        pt = dataclasses.replace(pt, node_valid=valid.copy())
        placed, prof = auditor().profiled(lambda: sched.reschedule(
            pt, delta=ProblemDelta(node_valid=valid.copy())))
        record("warm_one_more_node_down_profiled" + (f":{i}" if i else ""),
               placed, pt)
        return prof

    no_h2d_in_dispatch(attempt, REFINE_RANGE, "h2d")


def deactivate_rows(pt, start: int):
    """Rows [start:] made inert as phantom services are (zero demand, no
    conflict or coloc ids, eligible everywhere) until the tenant arrives."""
    out = dataclasses.replace(
        pt, demand=pt.demand.copy(), port_ids=pt.port_ids.copy(),
        volume_ids=pt.volume_ids.copy(), anti_ids=pt.anti_ids.copy(),
        coloc_ids=pt.coloc_ids.copy(), eligible=pt.eligible.copy())
    out.demand[start:] = 0.0
    for arr in (out.port_ids, out.volume_ids, out.anti_ids, out.coloc_ids):
        arr[start:] = -1
    out.eligible[start:] = True
    return out


def with_arrivals(np, pt, k: int, rng):
    """`pt` with k id-free services appended (demands drawn from the real
    rows', eligible on every node) and the delta that writes them into
    phantom rows."""
    grow = lambda a: np.concatenate(  # noqa: E731
        [a, np.full((k, a.shape[1]), -1, dtype=a.dtype)])
    dem = pt.demand[rng.choice(pt.S, k, replace=False)].astype(np.float32)
    elig = np.ones((k, pt.N), dtype=bool)
    names = [f"arrival{i}" for i in range(k)]
    pt2 = dataclasses.replace(
        pt, service_names=pt.service_names + names,
        demand=np.concatenate([pt.demand, dem]),
        eligible=np.concatenate([pt.eligible, elig]),
        dep_adj=np.pad(pt.dep_adj, ((0, k), (0, k))),
        dep_depth=np.concatenate([pt.dep_depth,
                                  np.zeros(k, pt.dep_depth.dtype)]),
        port_ids=grow(pt.port_ids), volume_ids=grow(pt.volume_ids),
        anti_ids=grow(pt.anti_ids), coloc_ids=grow(pt.coloc_ids),
        replica_of=(pt.replica_of + names if pt.replica_of
                    else pt.replica_of))
    rows = np.arange(pt.S, pt.S + k)
    return pt2, dict(demand_rows=(rows, dem), eligible_rows=(rows, elig),
                     n_real=pt2.S)


def closure_kept(np, index, prev, new, cur, scattered) -> int:
    """A localized solve moves only rows of the churn's closure: every row
    outside closure(stranded ∪ scattered) keeps its previous node. Returns
    the closure size; raises on a row that escaped it."""
    S_old, S = prev.shape[0], cur.S
    park = int(np.argmax(cur.node_valid))
    prev_full = np.concatenate([prev, np.full(S - S_old, park, np.int32)])
    stranded = np.flatnonzero(~(cur.node_valid[prev_full]
                                & cur.eligible[np.arange(S), prev_full]))
    affected = np.union1d(stranded, np.asarray(scattered, dtype=np.int64))
    inside = np.zeros(S, dtype=bool)
    inside[index.closure(affected)] = True
    escaped = np.flatnonzero(~inside[:S_old] & (new[:S_old] != prev))
    if escaped.size:
        raise AssertionError(f"localized solve moved {escaped.size} rows "
                             f"outside the closure: {escaped[:10]}")
    return int(inside.sum())


def busiest(np, assignment, valid, k: int):
    """The k live nodes hosting most services."""
    loads = np.bincount(assignment, minlength=valid.shape[0]).astype(
        np.float64)
    loads[~valid] = -1.0
    return np.argsort(loads)[-k:]


def drive_default(np, pt, sched, ProblemDelta, record, index, S: int,
                  tenant: tuple, replay: Optional[list] = None):
    """The [default] phase's solves: cold, the burst pattern, one arrival
    into phantom rows, rolling kills. Each kill takes the busiest live
    nodes of the previous placement, or with `replay` the node masks of an
    earlier drive, in order. Returns (rows, pt, valid, masks)."""
    arr_rows, arr_dem, arr_elig = tenant
    rows = [record("cold", sched.place(pt), pt)]
    prev = sched.last_result.assignment
    valid = pt.node_valid.copy()
    dead: deque = deque()
    masks: list = []

    def burst(label, cur, delta_kw, scattered=()):
        placed = sched.reschedule(cur, delta=ProblemDelta(**delta_kw))
        res = sched.last_result
        sub = res.subsolve
        extra = dict(kind=label.split(":")[0],
                     delta_stage_ms=round(res.timings_ms.get(
                         "delta_stage_ms", 0.0), 3),
                     subsolve=None if sub is None else {
                         k: sub[k] for k in ("outcome", "rows", "tier",
                                             "ms")},
                     moved=int((placed.raw[:prev.shape[0]] != prev).sum()))
        if sub is not None and sub["outcome"] == "localized":
            extra["closure"] = closure_kept(np, index, prev, placed.raw, cur,
                                            scattered)
        rows.append(record(label, placed, cur, **extra))
        return placed.raw

    def kill(valid, k, revive_after):
        if replay is not None:
            masks.append(replay[len(masks)])
            return masks[-1].copy()
        victims = busiest(np, prev, valid, k)
        valid = valid.copy()
        valid[victims] = False
        if len(dead) >= revive_after:
            valid[dead.popleft()] = True
        dead.append(victims)
        masks.append(valid.copy())
        return valid

    for i, kind in enumerate(BURSTS):
        valid = kill(valid, 1 if kind == "kill1" else 3, 2)
        fields, delta_kw, scattered = {}, dict(node_valid=valid), ()
        if kind in ("arrive", "depart"):
            tdem = arr_dem if kind == "arrive" else np.zeros_like(arr_dem)
            telig = arr_elig if kind == "arrive" else np.ones_like(arr_elig)
            demand, eligible = pt.demand.copy(), pt.eligible.copy()
            demand[S:] = tdem
            eligible[S:] = telig
            fields = dict(demand=demand, eligible=eligible)
            delta_kw.update(demand_rows=(arr_rows, tdem),
                            eligible_rows=(arr_rows, telig))
            scattered = arr_rows
        pt = dataclasses.replace(pt, node_valid=valid, **fields)
        prev = burst(f"{kind}:{i}", pt, delta_kw, scattered)

    pt, delta_kw = with_arrivals(np, dataclasses.replace(pt, node_valid=valid),
                                 ARRIVALS, np.random.default_rng(1))
    prev = burst("arrival_n_real", pt, dict(delta_kw, node_valid=valid),
                 delta_kw["demand_rows"][0])

    for i in range(ROLLING_KILLS):
        valid = kill(valid, 1, 2)
        pt = dataclasses.replace(pt, node_valid=valid)
        prev = burst(f"rolling_kill:{i}", pt, dict(node_valid=valid))
    return rows, pt, valid, masks


def default_fleet(np, lower, S=N_SERVICES, N=N_NODES,
                  tenant_rows=TENANT_ROWS):
    """The [default] phase's fleet: the headline problem with S +
    `tenant_rows` rows, the last ones an inert tenant stage. Returns (pt,
    tenant rows, demand and eligibility)."""
    full = lower.synthetic_problem(S + tenant_rows, N, seed=0, n_tenants=8,
                                   port_fraction=0.2, volume_fraction=0.1)
    tenant = (np.arange(S, S + tenant_rows),
              full.demand[S:].astype(np.float32), full.eligible[S:].copy())
    return deactivate_rows(full, S), tenant


def host_copy(t):
    """A copy of tensor `t` on the CPU (a copy also when `t` lies there)."""
    return None if t is None else t.to("cpu", copy=True)


def cpu_problem(prob):
    """A TorchProblem's tensors copied to the CPU."""
    from fleetflow_tpu_torch.solver.problem import TENSOR_FIELDS
    return dataclasses.replace(prob, **{
        name: host_copy(t) for name, t in zip(TENSOR_FIELDS, prob.tensors())
        if t is not None})


@contextmanager
def stages_kept(torch, subsolve, sched):
    """Keep, for every sub-solve the block runs, what its K5 stage was
    given and gave: CPU copies of the resident staging, the host mirror
    the plan was made from, the device assignment, the staged buffer and
    the kernel's outputs, and the uploads ``stage_subsolve`` made (count,
    bytes). The copies are taken after the launch (one sync a sub-solve);
    the check runs after the block."""
    kept: list = []
    real_stage, real_upload = subsolve.k5_stage, subsolve.stage_subsolve
    uploads: list = []

    def stage_subsolve(resident, plan):
        before = resident.h2d_copies
        staged = real_upload(resident, plan)
        uploads.append((resident.h2d_copies - before,
                        staged.numel() * staged.element_size()))
        return staged

    def k5_stage(prob, assignment, staged, plan):
        out = real_stage(prob, assignment, staged, plan)
        torch.cuda.synchronize()
        mirror = sched._slots[0].resident._mirror
        kept.append(dict(
            prob=cpu_problem(prob), assignment=host_copy(assignment),
            mirror=None if mirror is None else mirror.copy(),
            staged=host_copy(staged), plan=plan, upload=uploads[-1],
            out=[host_copy(t) for t in out]))
        return out

    subsolve.k5_stage, subsolve.stage_subsolve = k5_stage, stage_subsolve
    try:
        yield kept
    finally:
        subsolve.k5_stage, subsolve.stage_subsolve = real_stage, real_upload


def check_kept_stages(torch, subsolve, kept: list, n_subs: int) -> None:
    """Every kept K5 stage against k5_stage_plain on the CPU copies, with
    the host mirror as the assignment: equal on every output (so the
    mirror the planner read is the device assignment on every real row,
    or the frozen base would differ), and its plan uploaded as one copy
    of O(tier + G_sub + Gc_sub) int32s."""
    if len(kept) != n_subs:
        raise AssertionError(f"{len(kept)} K5 stages kept for {n_subs} "
                             f"sub-solves")
    for i, k in enumerate(kept):
        plan = k["plan"]
        n = plan.n_real
        if k["mirror"] is None or not torch.equal(
                torch.from_numpy(k["mirror"][:n]), k["assignment"][:n]):
            raise AssertionError(f"sub-solve {i}: the host mirror differs "
                                 f"from the device assignment")
        ref = subsolve.k5_stage_plain(k["prob"], torch.tensor(k["mirror"]),
                                      k["staged"], plan)
        for name, x, y in zip(subsolve.SubStage._fields, k["out"], ref):
            if (x is None) != (y is None) or (
                    x is not None and not (x.dtype == y.dtype
                                           and torch.equal(x, y))):
                raise AssertionError(f"sub-solve {i}: K5 stage {name} "
                                     f"differs from the plain stage")
        copies, nbytes = k["upload"]
        want = 4 * (plan.tier + len(plan.conf_ids) + len(plan.coloc_ids))
        if copies != 1 or nbytes != want:
            raise AssertionError(f"sub-solve {i}: {copies} uploads of "
                                 f"{nbytes} bytes (want 1 of {want})")
        print(f"[k5_stage] sub-solve {i}: tier {plan.tier}, {plan.n_sub} "
              f"closure rows, G_sub {plan.G_sub} ({len(plan.conf_ids)} ids)"
              f", Gc_sub {plan.Gc_sub} ({len(plan.coloc_ids)}); 1 upload "
              f"of {nbytes} bytes; stage equal to the plain stage on the "
              f"mirror", flush=True)


def run_default_phase(torch, np, pkg_main, lower, dev_name, S=N_SERVICES,
                      N=N_NODES, tenant_rows=TENANT_ROWS):
    """Phase 4: GpuSolverScheduler() as a user creates it. Returns (launch
    counts, K5 record)."""
    GpuSolverScheduler, ProblemDelta, verify, _ext, subsolve = pkg_main
    pt, tenant = default_fleet(np, lower, S, N, tenant_rows)
    index = subsolve.ActiveIndex(pt)
    sched = GpuSolverScheduler()
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    sub_total = REGISTRY.get("fleet_solver_subsolve_total")
    outcomes0 = {k: sub_total.value(outcome=k) for k in subsolve.SUB_OUTCOMES}
    torch.cuda.synchronize()
    _ext.reset_launches()
    record = make_record(sched, verify, _ext, dev_name, "default")
    with stages_kept(torch, subsolve, sched) as kept:
        rows, pt, valid, masks = drive_default(np, pt, sched, ProblemDelta,
                                               record, index, S, tenant)
    launches = read_launches(torch, _ext, "default", KERNEL_NAMES[:5],
                             off=("k6_greedy_scan",), size=(pt.S, pt.N))
    outcomes = {k: int(sub_total.value(outcome=k) - v)
                for k, v in outcomes0.items()}
    subs = [r["subsolve"] for r in rows if r.get("subsolve")]
    tiers = sorted({s["tier"] for s in subs})
    localized = sum(s["outcome"] == "localized" for s in subs)
    print(f"[default] bucket {json.dumps(sched.last_result.bucket)}; "
          f"sub-solve outcomes {json.dumps(outcomes)}; tiers {tiers}",
          flush=True)
    if localized == 0 or len(tiers) < 2:
        raise AssertionError(f"{localized} localized bursts, mini tiers "
                             f"{tiers}: expected >= 1 and >= 2")
    if launches["k5_subsolve"] != 2 * len(subs):
        raise AssertionError(f"K5 launched {launches['k5_subsolve']} times "
                             f"for {len(subs)} sub-solves (2 each)")
    check_kept_stages(torch, subsolve, kept, len(subs))

    # one more localized reschedule under torch.profiler (the busiest live
    # node down): no host-to-device copy in the sub-solve's range
    from fleetflow_tpu_torch.solver.api import SUBSOLVE_RANGE

    def attempt(i):
        nonlocal pt, valid
        prev = sched.last_result.assignment
        valid = valid.copy()
        valid[busiest(np, prev, valid, 1)] = False
        pt = dataclasses.replace(pt, node_valid=valid)
        placed, prof = auditor().profiled(lambda: sched.reschedule(
            pt, delta=ProblemDelta(node_valid=valid)))
        row = record("kill1_profiled" + (f":{i}" if i else ""), placed, pt,
                     subsolve=sched.last_result.subsolve)
        if (row["subsolve"] or {}).get("outcome") != "localized":
            raise AssertionError(f"the profiled burst did not localize: "
                                 f"{row}")
        return prof

    no_h2d_in_dispatch(attempt, SUBSOLVE_RANGE, "h2d")
    return launches, check_k5(torch, np, sched, pt, valid, ProblemDelta,
                              subsolve), masks


def compare_subsolve(np, pkg_main, lower, dev_name, masks, S=N_SERVICES,
                     N=N_NODES, tenant_rows=TENANT_ROWS) -> dict:
    """The [default] solves again on fresh GpuSolverScheduler()s, the same
    padded fleet and the same node masks (those of phase 4), with the
    sub-solve off (FLEET_SUBSOLVE=0, the full path on every burst) and on,
    in the order off, on, on, off. Every solve passes the phase's checks.
    Prints each solve's wall ms both ways, with the on runs' plan_ms and
    subsolve_ms; returns the summed wall ms of the bursts by mode and the
    wall ms of every sub-solve-off burst that ran 0 sweeps (the full
    path's 0-sweep bursts)."""
    GpuSolverScheduler, ProblemDelta, verify, _ext, subsolve = pkg_main
    pt0, tenant = default_fleet(np, lower, S, N, tenant_rows)
    index = subsolve.ActiveIndex(pt0)
    runs: dict = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        with (subsolve_off() if mode == "off" else nullcontext()):
            sched = GpuSolverScheduler()
            record = make_record(sched, verify, _ext, dev_name,
                                 f"ab-{mode}", echo=False)
            rows = drive_default(np, pt0, sched, ProblemDelta, record,
                                 index, S, tenant, replay=masks)[0]
        subs = [r.get("subsolve") for r in rows[1:]]
        if mode == "off" and any(subs):
            raise AssertionError(f"FLEET_SUBSOLVE=0 ran a sub-solve: {subs}")
        runs[mode].append(rows)
    totals = {}
    for mode, rs in runs.items():
        totals[mode] = [round(sum(r["ms"] for r in rows[1:]), 3)
                        for rows in rs]
    for i, row in enumerate(runs["on"][0]):
        t_on = [rows[i]["timings_ms"] for rows in runs["on"]]
        print("[ab] " + json.dumps(dict(
            solve=row["solve"],
            off_ms=[rows[i]["ms"] for rows in runs["off"]],
            off_sweeps=[rows[i]["sweeps"] for rows in runs["off"]],
            on_ms=[rows[i]["ms"] for rows in runs["on"]],
            on_sweeps=[rows[i]["sweeps"] for rows in runs["on"]],
            outcome=[(rows[i].get("subsolve") or {}).get("outcome")
                     for rows in runs["on"]],
            plan_ms=[t.get("plan_ms") for t in t_on],
            subsolve_ms=[t.get("subsolve_ms") for t in t_on])), flush=True)
    print(f"[ab] bursts' summed wall ms (off, on, on, off order; by mode): "
          f"{json.dumps(totals)}", flush=True)
    full_zero_ms = [r["ms"] for rows in runs["off"] for r in rows[1:]
                    if r["sweeps"] == 0]
    return totals, full_zero_ms


OBS_MUX_K = 3               # [obs]'s solve_multiplexed batch (rung 4)
OBS_BOOKKEEPING_CALLS = 1000
# the per-solve bookkeeping may cost at most this share of the full path's
# 0-sweep warm burst
OBS_COST_SHARE = 0.01
# the __global__ functions of the cold solve's kernels, as a Chrome trace
# names their events
OBS_KERNEL_SYMBOLS = {"k4_greedy": ("k4_seed",),
                      "k3_rebuild": ("k3_init", "k3_build", "k3_stats"),
                      "k1_sweep": ("k1_sweep_kernel",)}
# the record fields of a solve.trace event besides the payload
TRACE_FIELDS = {"S", "N", "warm", "resident", "violations", "pre_repair",
                "total_ms", "telemetry"}


def counter_delta(REGISTRY, before: dict) -> dict:
    """Every counter child that moved since the snapshot `before`."""
    now = REGISTRY.counter_values()
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if v != before.get(k, 0.0)}


def obs_expect(moved: dict, want: dict) -> None:
    """Each counter child of `want` moved by exactly its value."""
    bad = {k: (moved.get(k, 0.0), v) for k, v in want.items()
           if moved.get(k, 0.0) != v}
    if bad:
        raise AssertionError(f"[obs] counters moved (got, want): {bad}")


def obs_drive(torch, np, mods, lower, dev, fleet, tally, S=N_SERVICES,
              N=N_NODES, tenant_rows=TENANT_ROWS, mux_tier=None):
    """[obs]' solves, with FLEET_TRACE_FILE set by the caller: the
    [default] scheduler's cold place of the fleet and three bursts (the
    busiest node down; 64 arrivals into phantom rows; 5% of the nodes down
    with FLEET_SUBSOLVE=0, a sweeping full-path solve), one
    solve_multiplexed call of OBS_MUX_K resident-warm stages and one cold
    solve_sharded over a 1x8 mesh of the card. Returns (results in solve
    order as (kind, pt, result), what the drive implies each counter moved
    by, the sub-solves run). `tally(S, N)` is called after the scheduler's
    solves and after the others, with the fleet size they ran at."""
    (_ext, GpuSolverScheduler, ProblemDelta, verify, solve, ResidentProblem,
     multiplex, sharded) = mods
    dev_name = str(dev)
    pt, _tenant = default_fleet(np, lower, S, N, tenant_rows)
    sched = GpuSolverScheduler(device=dev)
    record = make_record(sched, verify, _ext, dev_name, "obs")
    solved: list = []

    def place(label, call, pt_now):
        placed = call()
        record(label, placed, pt_now, subsolve=sched.last_result.subsolve)
        solved.append(("sched", pt_now, sched.last_result))

    place("cold", lambda: sched.place(pt), pt)
    valid = pt.node_valid.copy()
    valid[busiest(np, sched.last_result.assignment, valid, 1)] = False
    pt = dataclasses.replace(pt, node_valid=valid.copy())
    place("kill1", lambda: sched.reschedule(
        pt, delta=ProblemDelta(node_valid=valid.copy())), pt)
    grown, delta_kw = with_arrivals(np, pt, ARRIVALS,
                                    np.random.default_rng(2))
    place("arrival_n_real", lambda: sched.reschedule(
        grown, delta=ProblemDelta(node_valid=valid.copy(), **delta_kw)),
        grown)
    alive = np.flatnonzero(valid)
    valid[np.random.default_rng(3).choice(alive, int(0.05 * grown.N),
                                          replace=False)] = False
    down = dataclasses.replace(grown, node_valid=valid.copy())
    with subsolve_off():
        place("warm_5pct_nodes_down", lambda: sched.reschedule(
            down, delta=ProblemDelta(node_valid=valid.copy())), down)
    full = solved[-1][2]
    if full.steps == 0 or full.subsolve is not None:
        raise AssertionError(f"[obs] the 5% burst ran {full.steps} sweeps, "
                             f"sub-solve {full.subsolve}: expected a "
                             f"sweeping full-path solve")
    tally(down.S, down.N)

    # one batch of OBS_MUX_K resident-warm stages (one node down each)
    mS, mN = mux_tier or MUX_TIERS[1]
    entries = []
    for i in range(OBS_MUX_K):
        st = fleet(mS, mN, 40 + i)
        rp = ResidentProblem(st, dev)
        cold = solve(st, prob=rp.prob, resident=rp, seed=i, steps=MUX_STEPS,
                     bucket=rp.bucket)
        solved.append(("mux_cold", st, cold))
        cur = dataclasses.replace(st, node_valid=st.node_valid.copy())
        cur.node_valid[int(np.bincount(cold.assignment,
                                       minlength=mN).argmax())] = False
        rp.apply_delta(cur, ProblemDelta(node_valid=cur.node_valid.copy()))
        entries.append(multiplex.MuxEntry(pt=cur, resident=rp, seed=i,
                                          stage=f"obs{i}"))
    with subsolve_off():
        lanes = multiplex.solve_multiplexed(entries, steps=MUX_STEPS,
                                            device=dev)
    for e, res in zip(entries, lanes):
        check_solve(res, e.pt, verify, dev_name, f"[obs] mux {e.stage}")
        solved.append(("mux_lane", e.pt, res))

    # one cold sharded solve over 1x8 positions of the card
    sh_pt = fleet(mS, mN, 40 + OBS_MUX_K)
    rp = sharded.ShardedResident(sh_pt, mesh=sharded.Mesh(
        [dev] * 8, (sharded.SVC_AXIS,)))
    sh_res = sharded.solve_sharded(sh_pt, resident=rp, steps=64, block=4)
    check_solve(sh_res, sh_pt, verify, dev_name, "[obs] sharded 1x8")
    solved.append(("sharded", sh_pt, sh_res))
    tally(mS, mN)

    def lbl(name, **labels):
        inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
        return f"{name}{{{inner}}}" if inner else name

    sched_res = [r for k, _p, r in solved if k == "sched"]
    subs = [r.subsolve["outcome"] for r in sched_res if r.subsolve]
    backend = "gpu" if dev.type == "cuda" else "cpu"
    want = {
        lbl("fleet_solver_solves_total", backend=backend, warm="false"):
            1 + OBS_MUX_K + 1,
        lbl("fleet_solver_solves_total", backend=backend, warm="true"):
            len(sched_res) - 1 + OBS_MUX_K,
        lbl("fleet_solver_sweeps_total"):
            sum(r.steps for _k, _p, r in solved),
        lbl("fleet_solver_mux_batches_total", k=multiplex.mux_k(OBS_MUX_K)):
            1,
        lbl("fleet_solver_mux_lanes_total", kind="stage"): OBS_MUX_K,
        lbl("fleet_solver_mux_lanes_total", kind="pad"):
            multiplex.mux_k(OBS_MUX_K) - OBS_MUX_K,
        lbl("fleet_solver_sharded_solves_total", outcome="cold"): 1,
        lbl("fleet_placements_total", source="gpu-anneal"): len(sched_res),
        lbl("fleet_solver_resident_reuse_total", outcome="cold"):
            1 + OBS_MUX_K + 1,
        lbl("fleet_solver_resident_reuse_total", outcome="delta"):
            len(sched_res) - 1 + OBS_MUX_K,
        lbl("fleet_solver_host_transfers_total"): 0,
        lbl("fleet_solver_compile_events_total"): 0,
    }
    for outcome in ("localized", "fallback_infeasible"):
        want[lbl("fleet_solver_subsolve_total", outcome=outcome)] = \
            subs.count(outcome)
    return solved, want, len(subs)


def obs_check_trace(trace_file: str, solved: list, read_trace_file) -> int:
    """One solve.trace record per solve, in solve order, each with the
    reference's fields and the payload of that solve's telemetry."""
    recs = [e for e in read_trace_file(trace_file)
            if e["kind"] == "telemetry" and e["name"] == "solve.trace"]
    if len(recs) != len(solved):
        raise AssertionError(f"[obs] {len(recs)} solve.trace records for "
                             f"{len(solved)} solves")
    for rec, (kind, pt_now, res) in zip(recs, solved):
        fields = rec["fields"]
        if set(fields) != TRACE_FIELDS:
            raise AssertionError(f"[obs] {kind} record fields "
                                 f"{sorted(fields)}")
        payload = json.loads(json.dumps(res.telemetry))
        if fields["telemetry"] != payload:
            raise AssertionError(f"[obs] {kind} record's payload differs "
                                 f"from its SolveResult.telemetry")
        if (fields["S"], fields["violations"]) != (pt_now.S, res.violations):
            raise AssertionError(f"[obs] {kind} record {fields['S']} rows, "
                                 f"{fields['violations']} violations")
    return len(recs)


def obs_profile_solver(torch, np, sched_pt, mods, dev, REGISTRY):
    """FLEET_PROFILE_SOLVER=1: the dispatch-delta gauge is the allocator's
    bytes read on either side of the last dispatch (torch.cuda
    .memory_allocated, spied on); without the variable nothing reads it."""
    (_ext, GpuSolverScheduler, ProblemDelta, verify) = mods
    real = torch.cuda.memory_allocated
    reads: list = []

    def spy(*a, **kw):
        reads.append(real(*a, **kw))
        return reads[-1]

    sched = GpuSolverScheduler(device=dev)
    record = make_record(sched, verify, _ext, str(dev), "obs", echo=False)
    pt = sched_pt
    record("profile_solver_cold", sched.place(pt), pt)
    gauge = REGISTRY.get("fleet_solver_dispatch_device_delta_bytes")
    torch.cuda.memory_allocated = spy
    try:
        valid = pt.node_valid.copy()
        for step, value in enumerate((None, "1")):
            with env_set(FLEET_PROFILE_SOLVER=value):
                gauge.set(-1.0)
                valid[busiest(np, sched.last_result.assignment, valid,
                              1)] = False
                pt = dataclasses.replace(pt, node_valid=valid.copy())
                record(f"profile_solver_{step}", sched.reschedule(
                    pt, delta=ProblemDelta(node_valid=valid.copy())), pt)
            if value is None and (reads or gauge.value() != -1.0):
                raise AssertionError(f"[obs] without FLEET_PROFILE_SOLVER "
                                     f"{len(reads)} allocator reads")
    finally:
        torch.cuda.memory_allocated = real
    if len(reads) < 2 or gauge.value() != reads[-1] - reads[-2]:
        raise AssertionError(f"[obs] dispatch delta {gauge.value()} from "
                             f"the allocator reads {reads}")
    print(f"[obs] FLEET_PROFILE_SOLVER=1: {len(reads)} allocator reads, "
          f"dispatch delta {gauge.value():.0f} bytes", flush=True)


def obs_profile_dir(torch, pt, solve, dev, prof_dir: str,
                    tries: int = H2D_TRIES) -> None:
    """FLEET_PROFILE_DIR: one cold solve() writes a Chrome trace holding
    the solve and fleet.refine ranges and the card's K4, K3 and K1 kernel
    events under their symbol names. A trace that lost its first device
    records (K4 is the solve's first launch; see probe_seen) is taken
    again on another cold solve, up to `tries`."""
    from fleetflow_tpu_torch.solver.api import REFINE_RANGE
    os.makedirs(prof_dir, exist_ok=True)
    for i in range(tries):
        before = set(os.listdir(prof_dir))
        with env_set(FLEET_PROFILE_DIR=prof_dir):
            res = solve(pt, device=dev)
        written = sorted(set(os.listdir(prof_dir)) - before)
        if len(written) != 1 or res.violations:
            raise AssertionError(f"[obs] FLEET_PROFILE_DIR: traces "
                                 f"{written}, {res.violations} violations")
        with open(os.path.join(prof_dir, written[0])) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = [e.get("name", "") for e in events
                   if e.get("cat") == "kernel"]
        # demangled, e.g. "(anonymous namespace)::k3_build(int, ...)"
        found = {name: sum(any(f"{sym}(" in k for sym in syms)
                           for k in kernels)
                 for name, syms in OBS_KERNEL_SYMBOLS.items()}
        if not {"solve", REFINE_RANGE} <= names:
            raise AssertionError(f"[obs] the trace {written[0]}: ranges "
                                 f"{sorted(n for n in names if 'fleet' in n)}")
        if all(found.values()):
            print(f"[obs] FLEET_PROFILE_DIR: {written[0]}, {len(events)} "
                  f"events, kernel events {json.dumps(found)}", flush=True)
            return
        print(f"[obs] FLEET_PROFILE_DIR: trace {i + 1} of {tries}, "
              f"{written[0]}, lost kernel events {json.dumps(found)}; "
              f"another cold solve", flush=True)
    raise AssertionError(f"[obs] FLEET_PROFILE_DIR: {tries} traces without "
                         f"every kernel's events")


def obs_bookkeeping_us(torch, api, res, pt, dev) -> dict:
    """Host µs a solve of the per-solve bookkeeping, on a recorded result,
    INFO disabled (library mode) and FLEET_TRACE_FILE unset: the solve
    families, the trace record's check and the solve line's
    (record_solve), and what the dispatch scope adds to the torch.profiler
    range it opens (the range itself predates the scope: its own µs are
    timed alone and subtracted)."""
    if api.log.isEnabledFor(logging.INFO):
        raise AssertionError("[obs] INFO is enabled: not library mode")
    n = OBS_BOOKKEEPING_CALLS
    t0 = time.perf_counter()
    for _ in range(n):
        api.record_solve(res, pt, steps=api.DEFAULT_STEPS, warm=True,
                         resident_warm=True, bucket_hit=True)
    record_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function(api.REFINE_RANGE):
            pass
    range_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        with api._dispatch_scope(api.REFINE_RANGE, dev):
            pass
    scope_us = (time.perf_counter() - t0) / n * 1e6
    return {"record_solve_us": round(record_us, 3),
            "dispatch_scope_us": round(scope_us, 3),
            "range_alone_us": round(range_us, 3),
            "per_solve_us": round(record_us + max(scope_us - range_us, 0.0),
                                  3)}


def run_obs_phase(torch, np, mods, lower, dev, fleet, full_zero_ms: list,
                  card: str, S=N_SERVICES, N=N_NODES,
                  tenant_rows=TENANT_ROWS, mux_tier=None):
    """[obs]: the port's observability on the card, outside every other
    phase's profiler. (1) the solve families moved as obs_drive's solves
    imply, the in-flight gauge back at 0; (2) FLEET_TRACE_FILE: one
    solve.trace record a solve, its payload that solve's telemetry; (3)
    FLEET_PROFILE_SOLVER=1: the dispatch delta read from the allocator;
    (4) FLEET_PROFILE_DIR: a cold solve's Chrome trace with its ranges and
    kernels; (5) the bookkeeping's host µs a solve beside the median wall
    ms of the run's full-path 0-sweep bursts (`full_zero_ms`, [ab]'s
    sub-solve-off bursts), at most OBS_COST_SHARE of it, printed with the
    `card` line. Returns the launch counts of (1)-(4)."""
    (_ext, GpuSolverScheduler, ProblemDelta, verify, solve, ResidentProblem,
     multiplex, sharded, api) = mods
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.obs.trace import read_trace_file
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fleetflow_tpu_torch", "_ext_build", "obs")
    os.makedirs(out_dir, exist_ok=True)
    trace_file = os.path.join(out_dir, f"flight.{os.getpid()}.jsonl")
    torch.cuda.synchronize()
    _ext.reset_launches()
    before = REGISTRY.counter_values()
    hist = REGISTRY.get("fleet_solver_subsolve_ms")
    sub_ms0 = hist.count()
    since: Optional[dict] = None

    def tally(S_run, N_run):
        nonlocal since
        since = tally_size(_ext, S_run, N_run, since)

    with env_set(FLEET_TRACE_FILE=trace_file, FLEET_PROFILE_SOLVER=None,
                 FLEET_PROFILE_DIR=None):
        solved, want, n_subs = obs_drive(
            torch, np, mods[:-1], lower, dev, fleet, tally, S, N,
            tenant_rows, mux_tier)
    moved = counter_delta(REGISTRY, before)
    obs_expect(moved, want)
    inflight = REGISTRY.get("fleet_solver_dispatches_in_flight").value()
    if inflight != 0 or hist.count() - sub_ms0 != n_subs:
        raise AssertionError(f"[obs] in flight {inflight}, sub-solve ms "
                             f"observed {hist.count() - sub_ms0} times for "
                             f"{n_subs} sub-solves")
    n_recs = obs_check_trace(trace_file, solved, read_trace_file)
    print(f"[obs] {len(solved)} solves, {n_recs} solve.trace records; "
          f"counters moved {json.dumps(moved, sort_keys=True)}", flush=True)

    sched_pt = default_fleet(np, lower, S, N, tenant_rows)[0]
    obs_profile_solver(torch, np, sched_pt, mods[:4], dev, REGISTRY)
    obs_profile_dir(torch, sched_pt, solve, dev,
                    os.path.join(out_dir, "profile"))
    tally(sched_pt.S, sched_pt.N)
    launches = read_launches(torch, _ext, "obs", KERNEL_NAMES[:5]
                             + ("k7_sharded_sweep",),
                             off=("k6_greedy_scan",))

    # (5) the bookkeeping's cost, on the 5% burst's recorded result
    _kind, pt5, res5 = [s for s in solved if s[0] == "sched"][-1]
    with env_set(FLEET_TRACE_FILE=None):
        cost = obs_bookkeeping_us(torch, api, res5, pt5, dev)
    zero = sorted(full_zero_ms)
    median_ms = statistics.median(zero) if zero else float("nan")
    share = cost["per_solve_us"] / (median_ms * 1e3)
    print(f"[obs] bookkeeping {json.dumps(cost)} a solve "
          f"({OBS_BOOKKEEPING_CALLS} calls); full-path 0-sweep burst "
          f"median {median_ms:.3f} ms over {len(zero)} bursts; share "
          f"{share:.5f}; {card}", flush=True)
    if not zero or not share <= OBS_COST_SHARE:
        raise AssertionError(f"[obs] bookkeeping {cost['per_solve_us']} µs "
                             f"against a {median_ms} ms burst")
    return launches


def host_planner_ms(np, subsolve, rp, plan) -> dict:
    """Host clock of the planner on the resident state `plan` came from,
    median of 5: plan_active in all, and its two parts, the closure (which
    reads dep_adj[:, inside] of the S x S matrix) and the closure's id
    lists (all that is left of the frozen base on the host)."""
    index, pt, mirror = rp._index, rp.pt, rp._mirror
    S = pt.S
    prev = mirror[:S]
    stranded = np.nonzero(~(pt.node_valid[prev]
                            & pt.eligible[np.arange(S), prev]))[0]
    rows = plan.rows[:plan.n_sub].astype(np.int64)
    calls = {
        "plan_active": lambda: subsolve.plan_active(
            index, pt, mirror, rp.prob.S, rp.prob.T,
            np.empty(0, np.int64), G_full=rp.prob.G, Gc_full=rp.prob.Gc),
        "closure": lambda: index.closure(stranded),
        "closure_ids": lambda: subsolve.closure_ids(index.conflict,
                                                    index.coloc, rows),
    }
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = round(statistics.median(times), 3)
    out["rows"] = int(plan.n_sub)
    out["ids"] = int(len(plan.conf_ids) + len(plan.coloc_ids))
    return out


def k5_bytes(prob, plan) -> dict:
    """Bytes K5 must move for `plan` on `prob`: the stage reads the real
    rows' assignment, each slot's demand, eligibility, preference and id
    rows, each frozen row's demand and id rows, the nodes' validity and
    domains and the plan buffer, and writes the slot planes and the base;
    the commit reads the (S,) assignment, the rows and the winner's slot
    values and writes the (S,) result and the chain."""
    N, tier, n_sub = prob.N, plan.tier, plan.n_sub
    K, C = prob.conflict_ids.shape[1], prob.coloc_ids.shape[1]
    elig = prob.eligible.shape[1] * prob.eligible.element_size()
    pref = 4.0 * N if prob.preferred is not None else 0.0
    slot_in = 12.0 + elig + pref + 4.0 * (K + C) + 4.0
    slot_out = 12.0 + elig + pref + 4.0 * (plan.Kc + plan.Cc) + 4.0
    frozen = plan.n_real - n_sub
    stage = (4.0 * plan.n_real + n_sub * slot_in + frozen * (
        12.0 + 4.0 * (K + C)) + 5.0 * N
        + 4.0 * (tier + len(plan.conf_ids) + len(plan.coloc_ids))
        + tier * slot_out
        + 4.0 * N * (3 + plan.G_sub + max(plan.Gc_sub, 1)) + 4.0 * prob.T)
    commit = 8.0 * prob.S + 4.0 * tier + 4.0 * n_sub + 16.0 + 4.0
    return dict(stage=stage, commit=commit)


def check_k5(torch, np, sched, pt, valid, ProblemDelta, subsolve):
    """K5 against its plain version on the plan of a kill3 burst (the
    three busiest live nodes down, merged into the resident state): its
    stage equal on every output to the plain stage on CPU copies of the
    resident staging with the host mirror as the assignment, its commits
    equal to the plain commit; the plan uploaded as one small copy;
    CUDA-event times of each entry point, of the plain versions and of the
    library calls (index_select gathers, clone + index_copy_)."""
    rp = sched._slots[0].resident
    prev = sched.last_result.assignment
    valid = valid.copy()
    valid[busiest(np, prev, valid, 3)] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    plan = rp.take_active_plan()
    if plan is None:
        raise AssertionError("the kill3 burst planned no sub-solve")
    planner = host_planner_ms(np, subsolve, rp, plan)
    prob, a = rp.prob, rp.assignment
    with stages_kept(torch, subsolve, sched) as kept:
        staged = subsolve.stage_subsolve(rp, plan)
        out_k = subsolve.k5_stage(prob, a, staged, plan)
    check_kept_stages(torch, subsolve, kept, 1)
    uploads = kept[0]["upload"]
    n_sub, tier = plan.n_sub, plan.tier
    rows = staged[:tier]
    # two chains: the staged seed, and the seed with its real rows
    # rotated by one node. Tied violations, so the least soft decides;
    # then violations decide against the soft score (the other chain's key
    # is +inf), either way round
    seed = out_k.seed
    chain1 = seed.clone()
    chain1[:n_sub] = (chain1[:n_sub] + 1) % prob.N
    best = torch.stack([seed, chain1])
    for v, f, want in (([0, 0], [0.5, 0.25], 1), ([1, 0], [-1.0, 5.0], 1),
                       ([0, 2], [3.0, -4.0], 0)):
        viol = torch.tensor(v, dtype=torch.float32, device=a.device)
        soft = torch.tensor(f, device=a.device)
        new_k, b_k = subsolve.k5_commit(best, viol, soft, rows, a)
        new_p, b_p = subsolve.k5_commit_plain(best, viol, soft, rows, a)
        torch.cuda.synchronize()
        if not (torch.equal(new_k, new_p) and torch.equal(b_k, b_p)
                and int(b_k[0]) == want):
            raise AssertionError(f"K5 commit differs (viol {v}, soft {f})")
        if want == 1 and torch.equal(new_k, a):
            raise AssertionError("K5 commit changed no row")
    viol = torch.zeros(2, device=a.device)
    soft = torch.tensor([0.5, 0.25], device=a.device)

    def stage_k():
        subsolve.k5_stage(prob, a, staged, plan)

    def stage_p():
        subsolve.k5_stage_plain(prob, a, staged, plan)

    def commit_k():
        subsolve.k5_commit(best, viol, soft, rows, a)

    def commit_p():
        subsolve.k5_commit_plain(best, viol, soft, rows, a)

    g = torch.clamp(rows.long(), max=prob.S - 1)
    keep = rows.long() < prob.S
    src = best[1][keep]

    def library():
        for plane in (prob.demand, prob.eligible, prob.preferred,
                      prob.conflict_ids, prob.coloc_ids, a):
            if plane is not None:
                torch.index_select(plane, 0, g)
        a.clone().index_copy_(0, rows.long()[keep], src)

    entries = {"stage": cuda_ms(torch, stage_k, reps=20),
               "commit": cuda_ms(torch, commit_k, reps=20)}
    ms = entries["stage"] + entries["commit"]
    plain = cuda_ms(torch, stage_p, reps=20) + cuda_ms(torch, commit_p,
                                                       reps=20)
    lib = cuda_ms(torch, library, reps=20)
    nbytes = k5_bytes(prob, plan)
    print(f"[planner] kill3 plan on the host: {json.dumps(planner)}",
          flush=True)
    print(f"[k5_subsolve] kill3 plan: {n_sub} closure rows in a tier of "
          f"{tier}; 1 upload of {uploads[1]} bytes; staged planes and base "
          f"and committed assignments equal; stage {entries['stage']:.4f} "
          f"ms, commit {entries['commit']:.4f} ms (event), plain "
          f"{plain:.4f} ms, library {lib:.4f} ms", flush=True)
    return dict(
        name="k5_subsolve", route="cuda",
        source="fleetflow_tpu_torch/csrc/k5_subsolve.cu",
        replaces="fleetflow_tpu/solver/subsolve.py:378",
        max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib, ops=0.0,
        bytes=nbytes["stage"] + nbytes["commit"], tier=tier, n_sub=n_sub,
        entries={k: dict(ms=v, bound_ms=nbytes[k] / PEAK_BYTES_S * 1e3)
                 for k, v in entries.items()},
        uploads=dict(copies=uploads[0], bytes=uploads[1]))


def profile_phases(torch, np, pkg_main, lower, pt) -> None:
    """--profile: phases 3 and 4 once more, each under torch.profiler;
    prints the kernels' device time by name and their share of the solves'
    wall time (the solves run slower under the profiler than without)."""
    GpuSolverScheduler, ProblemDelta, _verify, _ext, subsolve = pkg_main
    from torch.profiler import ProfilerActivity, profile
    from fleetflow_tpu_torch.solver.api import REFINE_RANGE, SUBSOLVE_RANGE

    def main_drive(record):
        with subsolve_off():
            drive_main_path(np, pt, GpuSolverScheduler(bucket=False),
                            ProblemDelta, record)

    def default_drive(record):
        pt0, tenant = default_fleet(np, lower)
        drive_default(np, pt0, GpuSolverScheduler(), ProblemDelta, record,
                      subsolve.ActiveIndex(pt0), N_SERVICES, tenant)

    for tag, drive in (("main", main_drive), ("default", default_drive)):
        walls = {}

        def record(label, placement, _pt, **_extra):
            walls[label] = round(placement.solve_ms, 3)
            return {}

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            drive(record)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue              # host-side ops; their kernels follow
            if ev.key in (REFINE_RANGE, SUBSOLVE_RANGE):
                continue              # a range's device-side span
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        solve_ms = sum(walls.values())
        print(f"[profile {tag}] solves under the profiler (ms): "
              f"{json.dumps(walls)}", flush=True)
        print(f"[profile {tag}] kernels busy {busy_ms:.3f} ms of "
              f"{solve_ms:.3f} ms of solves "
              f"({100 * busy_ms / solve_ms:.1f}%), "
              f"{sum(r[1] for r in rows)} kernel launches", flush=True)
        for dev_us, n, key in rows[:15]:
            print(f"[profile {tag}] {dev_us / 1e3:10.3f} ms {n:6d}x "
                  f"{key[:90]}", flush=True)


# -- the lane axis of K1-K3 and the tenant multiplexer ----------------------

MUX_TIERS = ((900, 100), (2000, 200))   # the reference bench's mux leg
MUX_KS = (2, 3, 5, 8)                   # ladder rungs 2, 4, 8
MUX_CAP_K = 16                          # the ladder's cap, at 2000x200
MUX_STEPS = 64
SLOT_STAGES = 12                        # keyed 2000x200 stages in [slots]
# what memory_allocated() may keep of an evicted slot's device_nbytes:
# none, since the allocator rounds each block UP (to 512 bytes), so freeing
# a slot's tensors drops it by at least their bytes
SLOT_ALLOWANCE = 0


def lane_problems(np, torch, problem, buckets, pts, dev):
    """The stagings of `pts` (one tier), each lane with its own node
    losses (the busiest nodes of a greedy seed, 1 + lane % 4 of them, and
    5% of the nodes on every other lane) and stickiness, stacked on a lane
    axis. Returns (stacked problem, solo problems, seeds (L, S))."""
    from fleetflow_tpu_torch.solver import greedy, multiplex
    solo, seeds = [], []
    for i, pt in enumerate(pts):
        prob, _ = buckets.stage_problem_tiers(pt, device=dev)
        order = np.concatenate([
            greedy.placement_order(pt.demand, pt.dep_depth,
                                   problem.unify_conflict_ids(pt)),
            np.arange(pt.S, prob.S, dtype=np.int32)])
        seed = greedy.greedy_place_batched(prob, torch.tensor(
            order, dtype=torch.int32, device=dev))
        k = 1 + i % 4 if i % 2 == 0 else max(1, prob.N // 20)
        dead = torch.bincount(seed.long(), minlength=prob.N).argsort(
            descending=True)[:k]
        valid = prob.node_valid.clone()
        valid[dead] = False
        solo.append(dataclasses.replace(prob, node_valid=valid,
                                        sticky_prev=seed,
                                        sticky_w=0.5 + 0.0625 * i))
        seeds.append(seed)
    return multiplex.stack_problems(solo), solo, torch.stack(seeds)


def check_lane_kernels(torch, np, pkg, dev, recs, tag, pts):
    """K1, K2 and K3 with a lane axis on the stagings of `pts`: each lane
    kernel against its plain version (a loop of the solo plain versions:
    integer planes, stats and moves equal, loads within LOAD_RTOL) and
    against the solo kernel launched lane by lane (bit-equal: the same
    code on the same data); CUDA-event times of both and the bound."""
    anneal, kernels, _greedy, problem, _lower, buckets = pkg
    torch.use_deterministic_algorithms(True, warn_only=True)
    prob, solo, seeds = lane_problems(np, torch, problem, buckets, pts, dev)
    L, S, N, G = prob.lanes, prob.S, prob.N, prob.G
    K, Kc = prob.conflict_ids.shape[-1], prob.coloc_ids.shape[-1]
    Gc1 = max(prob.Gc, 1)
    size = f"{pts[0].S}x{pts[0].N}"

    def lane_rec(name, ms, plain, err, t_bytes, t_ops, **extra):
        b_ms, o_ms = t_bytes / PEAK_BYTES_S * 1e3, t_ops / PEAK_OPS_S * 1e3
        recs[name].setdefault("lanes", []).append(dict(
            L=L, size=size, padded_S=S, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations", **extra))

    # K3: two chains a lane, the seed and a perturbed copy
    rng = np.random.default_rng(0)
    pert = seeds.clone()
    cols = torch.tensor(rng.choice(S, S // 3, replace=False), device=dev)
    pert[:, cols] = torch.tensor(rng.integers(0, 10, (L, cols.numel())),
                                 dtype=torch.int32, device=dev)
    both = torch.stack([seeds, pert], 1).contiguous()
    out_k = kernels.k3_rebuild(prob, both, with_stats=True)
    out_p = kernels.k3_rebuild_plain(prob, both, with_stats=True)
    torch.cuda.synchronize()
    for i in range(L):
        out_s = kernels.k3_rebuild(solo[i], both[i], with_stats=True)
        if not all(torch.equal(x[i], y) for x, y in zip(out_k, out_s)):
            raise AssertionError(f"[{tag}] K3 lane {i} differs from the "
                                 f"solo kernel")
    for name, a, b in zip(("used", "coloc", "topo", "stats"), out_k[1:],
                          out_p[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"[{tag}] K3 lanes: {name} differs")
    err = max_err(torch, out_k[0], out_p[0])
    if not torch.allclose(out_k[0], out_p[0], rtol=LOAD_RTOL, atol=0):
        raise AssertionError(f"[{tag}] K3 lanes: load differs by {err}")
    if float(out_k[4][:, 1, 4].min()) == 0:
        raise AssertionError(f"[{tag}] K3 lanes: a perturbed lane shows no "
                             f"violation")
    ms = cuda_ms(torch, lambda: kernels.k3_rebuild(prob, both,
                                                   with_stats=True), reps=10)
    plain = cuda_ms(torch, lambda: kernels.k3_rebuild_plain(
        prob, both, with_stats=True), reps=3)
    R = 2 * L
    lane_rec("k3_rebuild", ms, plain, err, L * (
        4.0 * (2 * S + S * 3 + S * K + S * Kc + N + N * 3 + 2 * S) + N)
        + 4.0 * R * (N * 3 + N * G + N * Gc1 + prob.T + 5), 0.0)
    print(f"[{tag}] K3 {L} lanes x 2 chains at {size} (padded {S}): equal to "
          f"the solo kernel lane by lane and to the plain version (load max "
          f"|err| {err:.3g}); kernel {ms:.3f} ms, plain {plain:.3f} ms",
          flush=True)

    # K1: 8 sweeps a lane from per-lane draws, each lane at its own
    # temperature and stickiness; lane 1 inactive for the last 4
    M = anneal.default_proposals_per_step(S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    base = anneal.chain_states_from_assignment(prob, both)
    temps = [1.0 / (1 + i) for i in range(L)]
    st_k, st_p, st_s = base.clone(), base.clone(), base.clone()
    applied = 0
    draws = []
    for sweep in range(8):
        per = [anneal.draw_proposals(solo[i], st_k.lane(i), gen, M)
               for i in range(L)]
        s_idx, b_idx, u = (torch.stack([d[k] for d in per]) for k in range(3))
        draws.append((s_idx, b_idx, u))
        active = [i != 1 or sweep < 4 for i in range(L)]
        _, acc_k = anneal.batched_step_apply(prob, st_k, s_idx, b_idx, u,
                                             temps, active)
        _, acc_p = anneal.batched_step_plain(prob, st_p, s_idx, b_idx, u,
                                             temps, active)
        for i in range(L):
            if active[i]:
                anneal.batched_step_apply(solo[i], st_s.lane(i), s_idx[i],
                                          b_idx[i], u[i], temps[i])
        if not torch.equal(acc_k, acc_p):
            raise AssertionError(f"[{tag}] K1 lanes: applied counts differ")
        applied += int(acc_k.sum())
    torch.cuda.synchronize()
    for name in ("assignment", "used", "coloc", "topo"):
        if not torch.equal(getattr(st_k, name), getattr(st_p, name)):
            raise AssertionError(f"[{tag}] K1 lanes: {name} differs")
    for x, y in zip(st_k, st_s):
        if not torch.equal(x, y):
            raise AssertionError(f"[{tag}] K1 lanes differ from the solo "
                                 f"kernel")
    # over 16 chains and 8 sweeps a node can lose most of its services in
    # one sweep: the kernel (one at a time, proposal order) and the plain
    # index_add_ (grouped) then leave different residues of the cancelled
    # sum, so loads agree within LOAD_RTOL of the plane's largest load
    k1_err = max_err(torch, st_k.load, st_p.load)
    atol = LOAD_RTOL * float(st_p.load.abs().max())
    close = torch.isclose(st_k.load, st_p.load, rtol=LOAD_RTOL, atol=atol)
    if not bool(close.all()):
        raise AssertionError(
            f"[{tag}] K1 lanes: {int((~close).sum())} loads differ, "
            f"{st_k.load[~close][:4].tolist()} against the plain "
            f"{st_p.load[~close][:4].tolist()}")
    if applied == 0:
        raise AssertionError(f"[{tag}] K1 lanes applied no move")
    s_idx, b_idx, u = draws[0]
    per_prop = sweep_prop_bytes(K, Kc)
    times = []
    for temp in K1_TEMPS:
        ms = cuda_ms(torch, lambda sweep: sweep(s_idx, b_idx, u, [temp] * L),
                     setup=lambda: (anneal.sweep_launcher(
                         prob, base.clone(), M),), reps=20)
        plain = cuda_ms(torch, lambda st: anneal.batched_step_plain(
            prob, st, s_idx, b_idx, u, [temp] * L),
            setup=lambda: (base.clone(),), reps=3)
        lane_rec("k1_sweep", ms, plain, k1_err, R * M * per_prop + R * 4.0,
                 R * M * 120.0, T=temp)
        times.append(f"T={temp:g} kernel {ms:.3f} ms, plain {plain:.3f} ms")
    print(f"[{tag}] K1 {L} lanes x 2 chains x {M} proposals, 8 sweeps "
          f"({applied} moves; lane 1 frozen for 4): equal to the solo kernel "
          f"and to the plain version (load max |err| {k1_err:.3g}); "
          f"{'; '.join(times)}", flush=True)

    # K2: each lane's seed, with its own nodes down
    st0 = anneal.chain_states_from_assignment(prob, seeds)
    st_k, st_p = st0.clone(), st0.clone()
    _, mv_k = anneal.prerepair_state_counted(prob, st_k, 256)
    _, mv_p = anneal.prerepair_plain(prob, st_p, 256)
    torch.cuda.synchronize()
    for i in range(L):
        st_s = st0.lane(i).clone()
        _, mv_s = anneal.prerepair_state_counted(solo[i], st_s, 256)
        if int(mv_s[0]) != int(mv_k[i]) or not all(
                torch.equal(x, y[i]) for x, y in zip(st_s, st_k)):
            raise AssertionError(f"[{tag}] K2 lane {i} differs from the "
                                 f"solo kernel")
    if not torch.equal(mv_k, mv_p):
        raise AssertionError(f"[{tag}] K2 lanes: moves {mv_k.tolist()} != "
                             f"{mv_p.tolist()}")
    for x, y in zip(st_k, st_p):
        if not torch.equal(x, y):
            raise AssertionError(f"[{tag}] K2 lanes: state differs")
    moves = int(mv_k.sum())
    if int(mv_k.min()) == 0:
        raise AssertionError(f"[{tag}] K2 lanes: a lane moved nothing: "
                             f"{mv_k.tolist()}")
    ms = cuda_ms(torch, lambda st: anneal.prerepair_state_counted(
        prob, st, 256), setup=lambda: (st0.clone(),))
    plain = cuda_ms(torch, lambda st: anneal.prerepair_plain(prob, st, 256),
                    setup=lambda: (st0.clone(),), reps=2)
    cost = k2_cost(prob, moves, L)
    lane_rec("k2_prerepair", ms, plain, 0.0, cost["bytes"], cost["ops"])
    print(f"[{tag}] K2 {L} lanes: moves {mv_k.tolist()}, equal to the solo "
          f"kernel and to the plain version; kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms", flush=True)
    torch.use_deterministic_algorithms(False)


def check_k2_tiers(torch, np, pkg, dev, recs) -> None:
    """K2 where ``[mux]`` launches it: the mux leg's 2000x200 and 900x100
    stagings (bucketed), each stage from its K4 seed with one node down
    and with 15% of the nodes down, stage 0 alone and 8 stages as 8
    lanes. Moves, assignment and integer planes equal to prerepair_plain,
    load max |err| 0; the kernel's CUDA-event ms (and that of the plain
    version's checking call), its iterations (the longest lane's stranded
    services, at most 256) and the bound, under the K2 line's `sizes`."""
    anneal, _kernels, greedy, problem, lower, buckets = pkg
    from fleetflow_tpu_torch.solver import multiplex
    fleet = mux_fleets(lower)
    torch.use_deterministic_algorithms(True, warn_only=True)
    for S, N in reversed(MUX_TIERS):
        for churn in ("1 node down", "15% down"):
            solos, seeds, stranded = [], [], []
            for i in range(8):
                pt = fleet(S, N, i)
                prob, _ = buckets.stage_problem_tiers(pt, device=dev)
                order = np.concatenate([
                    greedy.placement_order(pt.demand, pt.dep_depth,
                                           problem.unify_conflict_ids(pt)),
                    np.arange(pt.S, prob.S, dtype=np.int32)])
                seed = greedy.greedy_place_batched(prob, torch.tensor(
                    order, dtype=torch.int32, device=dev))
                dead = ([i % N] if churn == "1 node down" else
                        np.random.default_rng(10 + i).choice(
                            N, 3 * N // 20, replace=False))
                valid = prob.node_valid.clone()
                valid[torch.as_tensor(np.asarray(dead), device=dev)] = False
                prob = dataclasses.replace(prob, node_valid=valid)
                rows = torch.arange(prob.S, device=dev)
                stranded.append(int((~problem.eligible_lookup(
                    prob.eligible, rows, seed.long())
                    | ~valid[seed.long()]).sum()))
                solos.append(prob)
                seeds.append(seed)
            for label, prob, seed, L in (
                    (f"{S}x{N} {churn}", solos[0], seeds[0], 1),
                    (f"{S}x{N} {churn} L=8",
                     multiplex.stack_problems(solos), torch.stack(seeds), 8)):
                st0 = anneal.chain_states_from_assignment(prob, seed)
                st_k, st_p = st0.clone(), st0.clone()
                _, mv_k = anneal.prerepair_state_counted(prob, st_k, 256)
                with as_deployed(torch):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    _, mv_p = anneal.prerepair_plain(prob, st_p, 256)
                    end.record()
                    end.synchronize()
                plain = start.elapsed_time(end)
                if not torch.equal(mv_k, mv_p):
                    raise AssertionError(f"K2 at {label}: moves "
                                         f"{mv_k.tolist()} != {mv_p.tolist()}")
                for x, y in zip(st_k, st_p):
                    if not torch.equal(x, y):
                        raise AssertionError(f"K2 at {label}: state differs")
                moves = int(mv_k.sum())
                if moves == 0:
                    raise AssertionError(f"K2 at {label}: no move")
                ms = cuda_ms(torch, lambda st, prob=prob: (
                    anneal.prerepair_state_counted(prob, st, 256)),
                    setup=lambda st0=st0: (st0.clone(),), reps=10)
                iters = min(max(stranded[:L]), 256)
                size_rec(recs, "k2_prerepair", K2_HEAD, dict(
                    size=label, L=L, padded_S=prob.S, max_abs_err=0.0,
                    ms=ms, plain_ms=plain, moves=mv_k.tolist(),
                    iterations=iters, us_per_iteration=ms * 1e3 / iters,
                    **k2_cost(prob, moves, L)))
                print(f"[k2_prerepair] {label} (padded {prob.S}): moves "
                      f"{mv_k.tolist()}, equal state; kernel {ms:.3f} ms "
                      f"({ms * 1e3 / iters:.2f} us an iteration of {iters}),"
                      f" plain {plain:.3f} ms", flush=True)
    torch.use_deterministic_algorithms(False)


def same_lane(np, ref, got, label: str) -> None:
    """A batched lane is the solo resident-warm solve of its stage: the
    assignment, stats, sweeps, pre-repair moves and telemetry rows equal,
    the soft score within 1e-6 relative."""
    rt, gt = ref.telemetry or {}, got.telemetry or {}
    diffs = []
    if not np.array_equal(ref.assignment, got.assignment):
        diffs.append(f"{int((ref.assignment != got.assignment).sum())} "
                     f"services placed elsewhere")
    if ref.stats != got.stats:
        diffs.append(f"stats {ref.stats} != {got.stats}")
    if ref.steps != got.steps:
        diffs.append(f"sweeps {ref.steps} != {got.steps}")
    for key in ("blocks", "prerepair_moves", "exit_sweep", "trace_blocks",
                "init"):
        if rt.get(key) != gt.get(key):
            diffs.append(f"telemetry {key} differs")
    if abs(ref.soft - got.soft) > 1e-6 * max(abs(ref.soft), 1e-30):
        diffs.append(f"soft {ref.soft} != {got.soft}")
    if gt.get("path") != "mux":
        diffs.append(f"path {gt.get('path')}")
    if diffs:
        raise AssertionError(f"[mux] {label} differs from its solo solve: "
                             f"{'; '.join(diffs)}")


def lane_contract(pt, res, dev_name: str, label: str) -> None:
    """Every lane ends feasible on the card, with no host repair and
    nothing on a dead node."""
    on_dead = int((~pt.node_valid[res.assignment]).sum())
    if (res.violations or res.pre_repair_violations or res.moves_repaired
            or on_dead or res.device != dev_name):
        raise AssertionError(
            f"[mux] {label}: violations {res.violations}, pre-repair "
            f"{res.pre_repair_violations}, repair moves {res.moves_repaired}"
            f", on dead nodes {on_dead}, device {res.device}")


def mux_stage(solve, ResidentProblem, ProblemDelta, pt, seed: int, dead,
              dev, steps: int):
    """A resident-warm stage: `pt` staged on the card (bucketed, as the
    scheduler stages it) and cold-solved with `seed`, then the nodes
    `dead` killed through a delta. Returns (churned pt, resident)."""
    rp = ResidentProblem(pt, dev)
    solve(pt, prob=rp.prob, resident=rp, seed=seed, steps=steps,
          bucket=rp.bucket)
    valid = pt.node_valid.copy()
    valid[dead] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    return cur, rp


def mux_fleets(lower):
    """fleet(S, N, i): the reference bench mux leg's stage i at S x N,
    synthetic_problem(S, N, seed=i, port_fraction=0.3,
    volume_fraction=0.2), made once."""
    made: dict = {}

    def fleet(S, N, i):
        if (S, N, i) not in made:
            made[(S, N, i)] = lower.synthetic_problem(
                S, N, seed=i, port_fraction=0.3, volume_fraction=0.2)
        return made[(S, N, i)]
    return fleet


def run_mux_phase(torch, np, mods, fleet, dev_name, tenant_fleet):
    """[mux]: per tier and K, each lane of ONE solve_multiplexed batch held
    bit for bit against a solo resident-warm solve of a double-built stage
    (FLEET_SUBSOLVE=0, same seeds), the lane contract checked, and the
    batch's wall ms against the solo solves' (per stage); then one batch
    under torch.profiler with no host-to-device copy in its fleet.mux
    range. Returns (launch counts, rows)."""
    _ext, solve, ResidentProblem, ProblemDelta, multiplex = mods
    dev = torch.device(dev_name)

    def small_stage(S, N, i, steps):
        # one node killed a stage, as the reference's mux tests churn
        return mux_stage(solve, ResidentProblem, ProblemDelta, fleet(S, N, i),
                         i, [i % N], dev, steps)

    def heavy_stage(S, N, i, steps):
        # 15% of the nodes down, more than K2's 256 moves can clear: the
        # lanes sweep and exit on different sweeps
        dead = np.random.default_rng(10 + i).choice(N, 3 * N // 20,
                                                    replace=False)
        return mux_stage(solve, ResidentProblem, ProblemDelta, fleet(S, N, i),
                         i, dead, dev, steps)

    rng = np.random.default_rng(2)
    big_dead = [None, None]

    def big_stage(_S, _N, i, steps):
        # the headline fleet twice: one node down, then 5% of the nodes
        pt = tenant_fleet
        if big_dead[i] is None:
            k = 1 if i == 0 else pt.N // 20
            big_dead[i] = rng.choice(pt.N, k, replace=False)
        return mux_stage(solve, ResidentProblem, ProblemDelta, pt, i,
                         big_dead[i], dev, steps)

    # (S, N, K, stage factory, max sweeps): the bench leg's grid at its 64
    # sweeps, the ladder's cap, lanes that sweep, and the headline pair at
    # the scheduler's default 128
    grid = [(S, N, K, small_stage, MUX_STEPS)
            for S, N in MUX_TIERS for K in MUX_KS]
    grid.append((*MUX_TIERS[1], MUX_CAP_K, small_stage, MUX_STEPS))
    grid.append((*MUX_TIERS[1], 8, heavy_stage, MUX_STEPS))
    grid.append((tenant_fleet.S, tenant_fleet.N, 2, big_stage, 128))
    rows = []
    with subsolve_off():
        torch.cuda.synchronize()
        _ext.reset_launches()
        for S, N, K, build, steps in grid:
            at_start = dict(_ext.LAUNCHES)
            serial, serial_ms = [], []
            for i in range(K):
                cur, rp = build(S, N, i, steps)
                t = time.perf_counter()
                serial.append(solve(cur, prob=rp.prob, resident=rp,
                                    resident_warm=True, seed=100 + i,
                                    steps=steps, bucket=rp.bucket))
                serial_ms.append((time.perf_counter() - t) * 1e3)
            built = [build(S, N, i, steps) for i in range(K)]
            entries = [multiplex.MuxEntry(pt=cur, resident=rp, seed=100 + i)
                       for i, (cur, rp) in enumerate(built)]
            before = dict(_ext.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = multiplex.solve_multiplexed(entries, steps=steps,
                                              device=dev)
            batch_ms = (time.perf_counter() - t) * 1e3
            launched = {k: _ext.LAUNCHES[k] - before[k]
                        for k in ("k1_sweep", "k2_prerepair", "k3_rebuild")}
            for i, (got, (cur, _rp)) in enumerate(zip(res, built)):
                label = f"{S}x{N} K={K} lane {i}"
                same_lane(np, serial[i], got, label)
                lane_contract(cur, got, dev_name, label)
                if got.timings_ms.get("mux_k") != multiplex.mux_k(K):
                    raise AssertionError(f"[mux] {label} ran on rung "
                                         f"{got.timings_ms.get('mux_k')}")
            # (the plain versions of a CPU rehearsal launch nothing)
            if dev.type == "cuda" and launched["k2_prerepair"] != 1:
                raise AssertionError(f"[mux] {S}x{N} K={K}: launches "
                                     f"{launched}: one K2 for all lanes")
            row = dict(tier=f"{S}x{N}", padded_S=entries[0].resident.prob.S,
                       churn="15% down" if build is heavy_stage else
                       ("1 / 5% down" if build is big_stage else "1 down"),
                       K=K, ladder=multiplex.mux_k(K), steps=steps,
                       batch_ms=round(batch_ms, 3),
                       per_stage_mux=round(batch_ms / K, 3),
                       per_stage_serial=round(statistics.median(serial_ms),
                                              3),
                       serial_ms=[round(x, 3) for x in serial_ms],
                       mux_stack_ms=round(res[0].timings_ms["mux_stack_ms"],
                                          3),
                       sweeps=[r.steps for r in res],
                       prerepair_moves=[r.telemetry["prerepair_moves"]
                                        for r in res],
                       launches=launched)
            rows.append(row)
            print(f"[mux] {json.dumps(row)}", flush=True)
            tally_size(_ext, S, N, since=at_start)
        launches = read_launches(torch, _ext, "mux", KERNEL_NAMES[:4],
                                 off=("k5_subsolve", "k6_greedy_scan"))
        if not any(any(r["sweeps"]) for r in rows):
            raise AssertionError("[mux] no lane swept: K1 ran no lane")

        # one more batch under torch.profiler: the card makes no
        # host-to-device copy inside the batched dispatch
        S, N = MUX_TIERS[1]

        def attempt(k):
            built = [small_stage(S, N, i, MUX_STEPS) for i in range(8)]
            entries = [multiplex.MuxEntry(pt=cur, resident=rp,
                                          seed=300 + 8 * k + i)
                       for i, (cur, rp) in enumerate(built)]
            res, prof = auditor().profiled(lambda: multiplex.solve_multiplexed(
                entries, steps=MUX_STEPS, device=dev))
            for i, (got, (cur, _rp)) in enumerate(zip(res, built)):
                lane_contract(cur, got, dev_name, f"profiled lane {i}")
            return prof

        no_h2d_in_dispatch(attempt, multiplex.MUX_RANGE, "h2d")
    return launches, rows


def run_slots_phase(torch, np, mods, fleet, dev_name):
    """[slots]: the slot manager on the card with keyed 2000x200 stages.
    Count bound (12 stages, 8 slots: the 8 newest resident, 4 evicted with
    snapshots), the evictions' card memory freed, a warm re-admission
    bit-identical to a never-evicted control (FLEET_SUBSOLVE=0), a
    place_many of all 12 stages after churn (bit-identical to solo
    reschedules, its placements the seeds of the next), a 1-byte budget
    that keeps one slot and still places every stage, and the byte
    accounting. Returns the launch counts."""
    _ext, GpuSolverScheduler, ProblemDelta, verify = mods
    S, N = MUX_TIERS[1]
    pts = {f"s{i}": fleet(S, N, i) for i in range(SLOT_STAGES)}
    keys = list(pts)

    def placed_ok(pl, pt, label):
        host = verify(pt, pl.raw)
        if not pl.feasible or pl.violations or host["total"]:
            raise AssertionError(f"[slots] {label}: violations "
                                 f"{pl.violations}, host {host}")

    with subsolve_off():
        torch.cuda.synchronize()
        _ext.reset_launches()
        sched = GpuSolverScheduler()
        # each eviction's own drop of memory_allocated(), read on either
        # side of it (inside the place() that admits the next stage)
        drops = []
        evict = sched._evict

        def measured_evict(slot):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            evict(slot)
            torch.cuda.synchronize()
            drops.append(before - torch.cuda.memory_allocated())

        sched._evict = measured_evict
        for k in keys[:8]:
            placed_ok(sched.place(pts[k], stage=k), pts[k], k)
        torch.cuda.synchronize()
        mem8 = torch.cuda.memory_allocated()
        st8 = sched.slots_status()
        bytes8 = {s["stage"]: s["bytes"] for s in st8["slots"]}
        for k in keys[8:]:
            placed_ok(sched.place(pts[k], stage=k), pts[k], k)
        torch.cuda.synchronize()
        mem12 = torch.cuda.memory_allocated()
        st = sched.slots_status()
        resident = [s["stage"] for s in st["slots"]]
        evicted = [e["stage"] for e in st["evicted"]]
        if (resident != keys[::-1][:8] or evicted != keys[:4]
                or not all(e["snapshot"] for e in st["evicted"])):
            raise AssertionError(f"[slots] resident {resident}, evicted "
                                 f"{st['evicted']}")
        admitted = sum(s["bytes"] for s in st["slots"]
                       if s["stage"] in keys[8:])
        evicted_bytes = sum(bytes8[k] for k in keys[:4])
        freed = sum(drops)
        if len(drops) != 4 or freed < evicted_bytes - SLOT_ALLOWANCE:
            raise AssertionError(
                f"[slots] evictions freed {drops} bytes of the card, the "
                f"evicted slots held {evicted_bytes}")
        if sched.byte_drift() != 0 or st["resident_bytes"] != sum(
                s["bytes"] for s in st["slots"]):
            raise AssertionError(f"[slots] accounting: drift "
                                 f"{sched.byte_drift()}, {st}")
        print(f"[slots] 12 stages, 8 slots: resident {resident}, evicted "
              f"{evicted} with snapshots; the 4 evictions dropped "
              f"memory_allocated by {drops} = {freed} bytes for "
              f"{evicted_bytes} evicted (allowance {SLOT_ALLOWANCE}); "
              f"memory_allocated {mem8} -> {mem12} bytes over the 4 places "
              f"that admitted {admitted} bytes; resident_bytes "
              f"{st['resident_bytes']}, drift 0", flush=True)

        # warm re-admission of an evicted stage after churn (its busiest
        # node down) against a control scheduler that never evicted it
        k = keys[0]
        control = GpuSolverScheduler(resident_bytes=1 << 40)
        first = control.place(pts[k], stage=k)
        valid = pts[k].node_valid.copy()
        valid[int(np.bincount(first.raw, minlength=N).argmax())] = False
        cur = dataclasses.replace(pts[k], node_valid=valid)
        want = control.reschedule(cur, stage=k,
                                  delta=ProblemDelta(node_valid=valid))
        got = sched.reschedule(cur, stage=k,
                               delta=ProblemDelta(node_valid=valid))
        placed_ok(got, cur, "readmitted")
        if not np.array_equal(want.raw, got.raw) or not (
                cur.node_valid[got.raw].all()):
            raise AssertionError("[slots] the re-admitted stage differs from "
                                 "the never-evicted control")
        st = sched.slots_status()
        if st["slots"][0]["stage"] != k or st["slots"][0]["evictions"] != 1:
            raise AssertionError(f"[slots] re-admission: {st['slots'][0]}")
        print(f"[slots] {k} re-admitted warm after churn: bit-identical to "
              f"the never-evicted control ({sched.last_result.steps} sweeps,"
              f" {sched.last_result.timings_ms.get('total_ms', 0.0):.3f} ms "
              f"solve); evicted now "
              f"{[e['stage'] for e in st['evicted']]}", flush=True)

        # place_many over the bound: 12 warm keyed stages (4 of them
        # evicted) in one call under 8 slots; the call evicts nothing until
        # its solves are done, so every stage batches and equals a solo
        # reschedule on a scheduler that never evicts, and the evictions
        # after it keep the placements it returned
        # (each stage with its busiest node down)
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
        mux_lanes = REGISTRY.get("fleet_solver_mux_lanes_total")
        roomy = GpuSolverScheduler()
        roomy._max_slots = SLOT_STAGES
        many = GpuSolverScheduler()
        cur = {}
        for k in keys:
            first = roomy.place(pts[k], stage=k)
            many.place(pts[k], stage=k)
            valid = pts[k].node_valid.copy()
            valid[int(np.bincount(first.raw, minlength=N).argmax())] = False
            cur[k] = dataclasses.replace(pts[k], node_valid=valid)
        want = [roomy.reschedule(cur[k], stage=k, delta=ProblemDelta(
            node_valid=cur[k].node_valid.copy())) for k in keys]
        stages = mux_lanes.value(kind="stage")
        t_many = time.perf_counter()
        got = many.place_many([{"pt": cur[k], "warm_start": True, "stage": k,
                                "delta": ProblemDelta(
                                    node_valid=cur[k].node_valid.copy())}
                               for k in keys])
        many_ms = (time.perf_counter() - t_many) * 1e3
        for k, w, g in zip(keys, want, got):
            placed_ok(g, cur[k], f"place_many {k}")
            if not cur[k].node_valid[g.raw].all():
                raise AssertionError(f"[slots] place_many {k}: a service "
                                     f"on the dead node")
            if not np.array_equal(w.raw, g.raw):
                raise AssertionError(f"[slots] place_many {k} differs from "
                                     f"its solo reschedule")
        st = many.slots_status()
        if (mux_lanes.value(kind="stage") != stages + SLOT_STAGES
                or [s["stage"] for s in st["slots"]] != keys[::-1][:8]
                or many.byte_drift() != 0):
            raise AssertionError(f"[slots] place_many over the bound: {st}")
        for k, g in zip(keys[:4], got):
            again = many.reschedule(cur[k], stage=k)
            if not np.array_equal(again.raw, g.raw):
                raise AssertionError(f"[slots] {k} did not warm-start from "
                                     f"the placement place_many returned")
        print(f"[slots] place_many of {SLOT_STAGES} warm stages under 8 "
              f"slots: every stage batched ({many_ms:.3f} ms wall) and "
              f"bit-identical to its solo reschedule; the 4 evicted after it "
              f"re-admit from the placements it returned", flush=True)

        tiny = GpuSolverScheduler(resident_bytes=1)
        for k in keys[:3]:
            placed_ok(tiny.place(pts[k], stage=k), pts[k], f"tiny {k}")
        st = tiny.slots_status()
        if (len(st["slots"]) != 1 or st["slots"][0]["stage"] != keys[2]
                or st["budget_bytes"] != 1 or st["resident_bytes"] <= 0):
            raise AssertionError(f"[slots] 1-byte budget: {st}")
        print(f"[slots] 1-byte budget: one slot ({keys[2]}, "
              f"{st['resident_bytes']} bytes), every stage placed",
              flush=True)
        return read_launches(torch, _ext, "slots", KERNEL_NAMES[:4],
                             off=("k5_subsolve", "k6_greedy_scan"),
                             size=(S, N))


def profile_mux(torch, mods, fleet, dev_name) -> None:
    """--profile: 8 stages of 2000x200 (one node killed a stage) solved
    one by one, and the same stages (double-built) in one batch, each
    under torch.profiler: wall ms, kernels' device time and their count."""
    from torch.profiler import ProfilerActivity, profile
    from fleetflow_tpu_torch.solver.api import REFINE_RANGE
    _ext, solve, ResidentProblem, ProblemDelta, multiplex = mods
    ranges = (REFINE_RANGE, multiplex.MUX_RANGE)
    dev = torch.device(dev_name)
    S, N = MUX_TIERS[1]

    def stages():
        return [mux_stage(solve, ResidentProblem, ProblemDelta,
                          fleet(S, N, i), i, [i % N], dev, MUX_STEPS)
                for i in range(8)]

    def serial(built):
        for i, (cur, rp) in enumerate(built):
            solve(cur, prob=rp.prob, resident=rp, resident_warm=True,
                  seed=100 + i, steps=MUX_STEPS, bucket=rp.bucket)

    def batched(built):
        multiplex.solve_multiplexed(
            [multiplex.MuxEntry(pt=cur, resident=rp, seed=100 + i)
             for i, (cur, rp) in enumerate(built)], steps=MUX_STEPS,
            device=dev)

    with subsolve_off():
        for tag, run in (("serial", serial), ("batched", batched)):
            built = stages()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                run(built)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            busy, launches = 0.0, 0
            for ev in prof.key_averages():
                # a range's device-side span is not a kernel
                if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                        and ev.key not in ranges):
                    busy += getattr(ev, "self_device_time_total",
                                    getattr(ev, "self_cuda_time_total", 0))
                    launches += ev.count
            print(f"[profile mux] 8 stages of {S}x{N}, {tag}: {wall:.3f} ms "
                  f"under the profiler, kernels busy {busy / 1e3:.3f} ms "
                  f"({100 * busy / 1e3 / wall:.1f}%), {launches} device "
                  f"operations", flush=True)


def scan_order(torch, np, greedy, problem, pt, prob, dev):
    """The placement order of `pt` on the card, the phantom rows of a padded
    staging appended last."""
    order = greedy.placement_order(pt.demand, pt.dep_depth,
                                   problem.unify_conflict_ids(pt))
    if prob.S > pt.S:
        order = np.concatenate([order, np.arange(pt.S, prob.S,
                                                 dtype=np.int32)])
    return torch.tensor(order, dtype=torch.int32, device=dev)


def check_k6(torch, np, pkg, dev):
    """[k6_scan]: K6 against its plain version, equal assignments, at the
    headline size (spread, both timed with CUDA events), at 2000x200
    with pack, fill_lowest and a best-effort instance (nodes at 45% of
    their capacity: the later services fit nowhere), and at 512 x 3,000
    spread with a preference plane (more nodes than a block has threads);
    each size's kernel ms and microseconds a step. Returns K6's record."""
    greedy, problem, lower = pkg

    def case(label, pt, best_effort=True):
        """Check K6 against its plain version; the plain run's CUDA-event
        ms (one run: ~10,000 steps of small launches at the headline
        size)."""
        prob = problem.prepare_problem(pt, dev)
        order = scan_order(torch, np, greedy, problem, pt, prob, dev)
        got = greedy.greedy_place(prob, order, best_effort)
        out = []
        plain = cuda_ms(torch, lambda: out.append(
            greedy.greedy_place_plain(prob, order, best_effort)), reps=1,
            warmup=0)
        if not torch.equal(got, out[0]):
            raise AssertionError(f"K6 {label}: assignment differs in "
                                 f"{int((got != out[0]).sum())} services")
        return prob, order, plain

    pt = sharded_fleet(lower, (N_SERVICES, N_NODES))
    prob, order, plain = case("10k x 1k spread", pt)
    ms = cuda_ms(torch, lambda: greedy.greedy_place(prob, order))
    small = {}
    steps = {"10000x1000 spread": ms * 1e3 / order.shape[0]}
    for strategy in ("pack_into_dedicated", "fill_lowest", "best_effort"):
        pt2 = lower.synthetic_problem(
            2000, 200, seed=1, n_tenants=3,
            strategy=lower.PlacementStrategy(
                "spread_across_pool" if strategy == "best_effort"
                else strategy))
        if strategy == "best_effort":
            pt2 = dataclasses.replace(pt2, capacity=(
                pt2.capacity * np.float32(0.45)).astype(np.float32))
        prob2, order2, _plain = case(f"2000 x 200 {strategy}", pt2)
        small[strategy] = round(cuda_ms(
            torch, lambda: greedy.greedy_place(prob2, order2)), 3)
        steps[f"2000x200 {strategy}"] = small[strategy] * 1e3 / order2.shape[0]
    # strict mode on the best-effort instance: a service that fits nowhere
    # goes to node 0, with no best-effort pass
    prob_s, order_s, plain_s = case("2000 x 200 strict", pt2,
                                    best_effort=False)
    strict_ms = cuda_ms(torch, lambda: greedy.greedy_place(
        prob_s, order_s, best_effort=False))
    on0 = int((greedy.greedy_place(prob_s, order_s, best_effort=False)
               == 0).sum())
    small["strict"] = round(strict_ms, 3)
    steps["2000x200 strict"] = strict_ms * 1e3 / order_s.shape[0]
    ids_s = int((prob_s.conflict_ids >= 0).sum())
    strict_bound = bound_of(
        tensor_bytes(torch, prob_s.demand, prob_s.conflict_ids, order_s,
                     prob_s.eligible, prob_s.node_valid, prob_s.capacity,
                     prob_s.preferred) + 4.0 * prob_s.S,
        prob_s.S * prob_s.N * 30.0 + ids_s * prob_s.N)
    strict = dict(case="2000x200 at 45% capacity, best_effort=False",
                  ms=strict_ms, plain_ms=plain_s, bound_ms=strict_bound[0],
                  bound_by=strict_bound[1], on_node0=on0,
                  max_abs_err=0.0)
    print(f"[k6_scan] strict {json.dumps(strict)}", flush=True)
    # more nodes than a block has threads: each thread owns three
    pt3 = lower.synthetic_problem(512, 3000, seed=2, n_tenants=3)
    pref = np.random.default_rng(2).random((512, 3000)).astype(np.float32)
    pt3 = dataclasses.replace(pt3, preferred=pref * np.float32(0.5))
    prob3, order3, _plain = case("512 x 3000 spread preferred", pt3)
    small["512x3000_preferred"] = round(cuda_ms(
        torch, lambda: greedy.greedy_place(prob3, order3)), 3)
    steps["512x3000 spread preferred"] = (small["512x3000_preferred"] * 1e3
                                          / order3.shape[0])
    S, N = prob.S, prob.N
    ids = int((prob.conflict_ids >= 0).sum())
    print(f"[k6_scan] equal assignments at 10k x 1k spread, 2000 x 200 "
          f"{sorted(k for k in small if not k.startswith('512'))} and 512 x "
          f"3000; kernel {ms:.3f} ms, plain {plain:.3f} ms at 10k x 1k; "
          f"kernel ms {json.dumps(small)}; us a step "
          f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}",
          flush=True)
    return dict(
        name="k6_greedy_scan", route="cuda",
        source="fleetflow_tpu_torch/csrc/k6_greedy_scan.cu",
        replaces="fleetflow_tpu/solver/greedy.py:58",
        max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
        small_ms=small, us_per_step=steps, strict=strict,
        # per step: ~30 float32 operations a node (as K4's count) plus one
        # add per valid conflict id a node
        ops=S * N * 30.0 + ids * N,
        # what the function needs: each input read once (demand, ids,
        # order, the eligibility and preference planes, node_valid,
        # capacity) and the assignment written once. The running load and
        # occupancy are state the scan may keep on chip, not traffic.
        bytes=tensor_bytes(torch, prob.demand, prob.conflict_ids, order,
                           prob.eligible, prob.node_valid, prob.capacity,
                           prob.preferred) + 4.0 * S)


def tensor_bytes(torch, *objs) -> float:
    """Bytes of every tensor among `objs` (problems, states, tensors)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif hasattr(o, "tensors"):           # a TorchProblem
            total += tensor_bytes(torch, *o.tensors())
        elif isinstance(o, tuple):            # a ChainState
            total += tensor_bytes(torch, *o)
    return float(total)


def bound_of(t_bytes: float, t_ops: float):
    b_ms, o_ms = t_bytes / PEAK_BYTES_S * 1e3, t_ops / PEAK_OPS_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def measure_rows(torch, np, pkg, dev, recs) -> dict:
    """[rows]: the kernel table's rows that have no kernel of their own,
    at the headline size: pad_problem_tiers of the exact staging onto its
    tier ladder, and the carried-state reductions (state_violation_stats +
    state_soft_score of 2 chains), each timed with CUDA events beside its
    bound (bytes read once and written once); and the bound of
    ``_mux_refine``, the sum of the lane K1-K3 bounds of each lane
    check."""
    anneal, greedy, problem, lower, buckets = pkg
    pt = lower.synthetic_problem(N_SERVICES, N_NODES, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    prob = problem.prepare_problem(pt, dev)
    padded, _info = buckets.pad_problem_tiers(prob)
    pad_ms = cuda_ms(torch, lambda: buckets.pad_problem_tiers(prob))
    # a staging already on its tiers comes back as itself: nothing moves
    pad_bound = bound_of(tensor_bytes(torch, prob, padded)
                         if padded is not prob else 0.0, 0.0)
    order = scan_order(torch, np, greedy, problem, pt, prob, dev)
    seed = greedy.greedy_place_batched(prob, order)
    st = anneal.chain_states_from_assignment(
        prob, torch.stack([seed, torch.roll(seed, 1)]))

    def reduce():
        anneal.state_violation_stats(prob, st)
        anneal.state_soft_score(prob, st)

    red_ms = cuda_ms(torch, reduce)
    # read: the state, capacity, node_valid, one eligibility word and one
    # preference per (chain, service) when the plane is present; ~3
    # operations per state element
    C, S = st.assignment.shape
    red_bytes = (tensor_bytes(torch, st, prob.capacity, prob.node_valid)
                 + 4.0 * C * S * (1 + (prob.preferred is not None)))
    red_bound = bound_of(red_bytes, 3.0 * tensor_bytes(torch, st) / 4)
    mux = {}
    for lane in recs["k1_sweep"].get("lanes", []):
        key = (lane["L"], lane["size"])
        mux[f"L={key[0]} {key[1]}"] = sum(
            r["bound_ms"] for name in ("k1_sweep", "k2_prerepair",
                                       "k3_rebuild")
            for r in recs[name].get("lanes", [])
            if (r["L"], r["size"]) == key)
    rows = {"pad_problem_tiers": dict(ms=pad_ms, bound_ms=pad_bound[0],
                                      bound_by=pad_bound[1],
                                      padded_S=padded.S),
            "carried_reductions": dict(ms=red_ms, bound_ms=red_bound[0],
                                       bound_by=red_bound[1], chains=C),
            "mux_refine_bound_ms": mux}
    print(f"[rows] {json.dumps(rows)}", flush=True)
    return rows


def check_solve(res, pt_now, verify, dev_name: str, label: str) -> None:
    """A solve of [seeds]: feasible (host verify agrees), no violation
    before the host backstop, no repair move, nothing on a dead node, on
    the card."""
    host = verify(pt_now, res.assignment)
    on_dead = int((~pt_now.node_valid[res.assignment]).sum())
    if res.violations or host["total"] or on_dead:
        raise AssertionError(f"{label}: violations {res.violations}, host "
                             f"{host}, on dead nodes {on_dead}")
    if res.pre_repair_violations or res.moves_repaired:
        raise AssertionError(f"{label}: the device solve left "
                             f"{res.pre_repair_violations} violations, "
                             f"{res.moves_repaired} host repair moves")
    if res.device != dev_name:
        raise AssertionError(f"{label} solved on {res.device}")


def run_seeds_phase(torch, np, mods, pt, dev_name):
    """[seeds]: a cold solve of the headline fleet with each seed_impl,
    then one node down and 5% of the nodes down with the legacy host
    pre-repair (prerepair=True), through init_assignment and through a
    resident-warm staging. Returns the launch counts of the phase (K2 and
    K5 must not launch: prerepair=True turns off the fused prologue)."""
    _ext, solve, verify, ResidentProblem, ProblemDelta = mods
    from fleetflow_tpu_torch.solver.api import SEED_IMPLS
    torch.cuda.synchronize()
    _ext.reset_launches()
    colds = {}
    for impl in SEED_IMPLS:
        t_solve = time.perf_counter()
        res = solve(pt, seed_impl=impl, seed=0)
        wall = (time.perf_counter() - t_solve) * 1e3
        check_solve(res, pt, verify, dev_name, f"cold {impl}")
        colds[impl] = res
        print(f"[seeds] {json.dumps(dict(seed_impl=impl, wall_ms=round(wall, 3), seed_ms=round(res.timings_ms['seed_ms'], 3), sweeps=res.steps, soft=round(res.soft, 6)))}",
              flush=True)
    rng = np.random.default_rng(4)
    cold = colds["batched"].assignment
    valid = pt.node_valid.copy()
    valid[int(np.bincount(cold, minlength=pt.N).argmax())] = False
    pt1 = dataclasses.replace(pt, node_valid=valid.copy())
    alive = np.flatnonzero(valid)
    valid[rng.choice(alive, int(0.05 * pt.N), replace=False)] = False
    pt2 = dataclasses.replace(pt, node_valid=valid.copy())
    rp = ResidentProblem(pt, torch.device(dev_name))
    res = solve(pt, prob=rp.prob, resident=rp, seed=0, bucket=rp.bucket)
    check_solve(res, pt, verify, dev_name, "resident cold")
    prev = {"init_assignment": cold, "resident": res.assignment}
    for label, cur in (("one_node_down", pt1), ("5pct_nodes_down", pt2)):
        for route in ("init_assignment", "resident"):
            t_solve = time.perf_counter()
            if route == "resident":
                rp.apply_delta(cur, ProblemDelta(
                    node_valid=cur.node_valid.copy()))
                res = solve(cur, prob=rp.prob, resident=rp,
                            resident_warm=True, prerepair=True, seed=1,
                            bucket=rp.bucket)
            else:
                res = solve(cur, init_assignment=prev[route],
                            prerepair=True, seed=1)
            wall = (time.perf_counter() - t_solve) * 1e3
            check_solve(res, cur, verify, dev_name, f"{label} {route}")
            if res.fused_prerepair or res.subsolve is not None:
                raise AssertionError(f"{label} {route}: prerepair=True ran "
                                     f"the fused prologue or the sub-solve")
            moved = float((res.assignment != prev[route]).mean())
            prev[route] = res.assignment
            print(f"[seeds] {json.dumps(dict(solve=label, route=route, wall_ms=round(wall, 3), prerepair_ms=round(res.timings_ms['prerepair_ms'], 3), sweeps=res.steps, moved=round(moved, 6), soft=round(res.soft, 6)))}",
                  flush=True)
    return read_launches(torch, _ext, "seeds",
                         ("k1_sweep", "k3_rebuild", "k4_greedy",
                          "k6_greedy_scan"),
                         off=("k2_prerepair", "k5_subsolve"),
                         size=(pt.S, pt.N))


def blocked_fleet(lower):
    """[fallback]'s 2000x200 stage: every 8th service may use only 10
    nodes, all of them down, so no placement is feasible."""
    pt = lower.synthetic_problem(2000, 200, seed=11, n_tenants=1)
    elig, valid = pt.eligible.copy(), pt.node_valid.copy()
    elig[::8] = False
    elig[::8, :10] = True
    valid[:10] = False
    return dataclasses.replace(pt, eligible=elig, node_valid=valid)


def run_fallback_phase(torch, np, mods, lower, dev_name):
    """[fallback]: place_with_fallback over GpuSolverScheduler() with a
    stage key, on a 2000x200 stage whose every 8th service may use only 10
    nodes that are all down (relax_order ["tier"]): the first solve is
    infeasible, the relaxed re-solve in the stage's slot is feasible. Then
    pick_scheduler at three sizes. Returns the launch counts."""
    (_ext, GpuSolverScheduler, place_with_fallback, relax_problem,
     pick_scheduler, verify) = mods
    pt = dataclasses.replace(blocked_fleet(lower), relax_order=["tier"])
    sched = GpuSolverScheduler()
    torch.cuda.synchronize()
    _ext.reset_launches()
    t_place = time.perf_counter()
    placement, relaxed = place_with_fallback(sched, pt,
                                             place_kwargs={"stage": "tier"})
    wall = (time.perf_counter() - t_place) * 1e3
    res = sched.last_result
    relaxed_pt = relax_problem(pt, "tier")
    if (relaxed != ["tier"] or not placement.feasible
            or not placement.source.endswith("+relaxed:tier")):
        raise AssertionError(f"[fallback] relaxed {relaxed}, feasible "
                             f"{placement.feasible}, {placement.source}")
    check_solve(res, relaxed_pt, verify, dev_name, "relaxed re-solve")
    keys = [s.key for s in sched._slots]
    if keys.count("tier") != 1:
        raise AssertionError(f"[fallback] slots {keys}: one for the stage")
    print(f"[fallback] {json.dumps(dict(relaxed=relaxed, source=placement.source, wall_ms=round(wall, 3), sweeps=res.steps, soft=round(res.soft, 6), slots=keys))}",
          flush=True)
    launches = read_launches(torch, _ext, "fallback",
                             ("k1_sweep", "k3_rebuild", "k4_greedy"),
                             off=("k2_prerepair", "k5_subsolve",
                                  "k6_greedy_scan"), size=(pt.S, pt.N))
    picks = {f"{S}x{N}": type(pick_scheduler(S, N)).__name__
             for S, N in ((4, 4), (2000, 200), (N_SERVICES, N_NODES))}
    picks[f"{N_SERVICES}x{N_NODES} prefer_gpu=False"] = type(pick_scheduler(
        N_SERVICES, N_NODES, prefer_gpu=False)).__name__
    print(f"[fallback] pick_scheduler {json.dumps(picks)}", flush=True)
    return launches


OPTIONS_BUDGET_S = 30.0     # the phase's time on the card's host
OPTIONS_WIDTH = 128         # [options] (b)'s proposal width
OPTIONS_ROUNDS = 5          # (a): each burst this many times
# (c)'s hot fixed budget: two sweeps at T = 5 leave capacity and conflict
# violations that the host repair moves away
OPTIONS_HOT = dict(steps=2, adaptive=False, t0=5.0)


def options_bursts(np, pt, first, ProblemDelta):
    """[options] (a)'s churn after a cold place `first`: one node down,
    5% of the nodes down, 64 arrivals into phantom rows. Yields (label,
    fleet, delta)."""
    rng = np.random.default_rng(0)
    valid = pt.node_valid.copy()
    valid[int(np.bincount(first, minlength=pt.N).argmax())] = False
    pt = dataclasses.replace(pt, node_valid=valid.copy())
    yield "one_node_down", pt, ProblemDelta(node_valid=valid.copy())
    alive = np.flatnonzero(valid)
    valid[rng.choice(alive, int(0.05 * pt.N), replace=False)] = False
    pt = dataclasses.replace(pt, node_valid=valid.copy())
    yield "5pct_nodes_down", pt, ProblemDelta(node_valid=valid.copy())
    pt, delta_kw = with_arrivals(np, pt, ARRIVALS, rng)
    yield "arrivals", pt, ProblemDelta(node_valid=valid.copy(), **delta_kw)


def spread(np, values) -> dict:
    """The median, least and greatest of `values` (ms)."""
    return dict(median=round(float(np.median(values)), 3),
                min=round(min(values), 3), max=round(max(values), 3))


def unrepaired(np, res, pt, verify, repaired, repair, label: str,
               moves: bool = False) -> dict:
    """[options] (c)'s check of a ``do_repair=False`` result `res` and the
    ``do_repair=True`` result `repaired` of the same call; with `moves`
    the repair must move rows and leave fewer violations."""
    host = verify(pt, res.assignment)
    if not (res.violations > 0 and res.violations == host["total"]
            and res.moves_repaired == 0 and not res.feasible
            and res.pre_repair_violations == res.violations):
        raise AssertionError(f"[options] {label} do_repair=False: "
                             f"violations {res.violations}, host {host}, "
                             f"moves {res.moves_repaired}")
    rr = repair(pt, res.assignment)
    if not (np.array_equal(repaired.assignment, rr.assignment)
            and repaired.moves_repaired == rr.moves):
        raise AssertionError(f"[options] {label}: do_repair=True is not the "
                             f"host repair of the device winner")
    if moves and not (repaired.moves_repaired > 0
                      and repaired.violations < res.violations):
        raise AssertionError(f"[options] {label}: the repair moved "
                             f"{repaired.moves_repaired} rows, violations "
                             f"{res.violations} -> {repaired.violations}")
    return dict(solve=label, violations=res.violations,
                repaired_violations=repaired.violations,
                repair_moves=rr.moves)


def run_options_phase(torch, np, mods, lower, dev, flow, pool, card):
    """[options]: the solver options beside the main path (see the module
    docstring): (a) overlap_host_work on the scheduler, OPTIONS_ROUNDS
    rounds of the same bursts, (b) the sharded path's callable and
    proposal width, (c) do_repair=False through solve, solve_multiplexed
    and solve_sharded. Returns the launch counts."""
    (_ext, GpuSolverScheduler, ProblemDelta, verify, solve, repair,
     ResidentProblem, multiplex, sharded) = mods
    dev_name = str(dev)
    t_phase = time.perf_counter()
    nodes = list(pool.servers.values())
    relowered = []

    def relower():
        relowered.append(lower.lower_stage(flow, "prod", nodes=nodes))

    pt = lower.synthetic_problem(N_SERVICES, N_NODES, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    torch.cuda.synchronize()
    _ext.reset_launches()
    # (a) the pipeline's overlap case on the scheduler: each round a fresh
    # pair from the same cold place, so a burst is the same work in every
    # round; A first on even (burst + round), B first on odd
    rows = []
    for rnd in range(OPTIONS_ROUNDS):
        a, b = GpuSolverScheduler(), GpuSolverScheduler()
        cold_a, cold_b = a.place(pt), b.place(pt)
        if not np.array_equal(cold_a.raw, cold_b.raw):
            raise AssertionError("[options] the two cold places differ")
        check_solve(a.last_result, pt, verify, dev_name, "[options] cold")
        for i, (label, cur, delta) in enumerate(options_bursts(
                np, pt, cold_a.raw, ProblemDelta)):
            walls = {}
            calls = len(relowered)
            for who in (("a", "b") if (i + rnd) % 2 == 0 else ("b", "a")):
                kw = dict(overlap_host_work=relower) if who == "a" else {}
                sched = a if who == "a" else b
                t0 = time.perf_counter()
                placed = sched.reschedule(cur, delta=delta, **kw)
                walls[who] = ((time.perf_counter() - t0) * 1e3, placed,
                              sched.last_result)
            t0 = time.perf_counter()
            lower.lower_stage(flow, "prod", nodes=nodes)
            relower_ms = (time.perf_counter() - t0) * 1e3
            (wall_a, pa, ra), (wall_b, pb, rb) = walls["a"], walls["b"]
            for res in (ra, rb):
                check_solve(res, cur, verify, dev_name, f"[options] {label}")
            t = ra.timings_ms
            if len(relowered) != calls + 1:
                raise AssertionError(f"[options] {label}: the callable ran "
                                     f"{len(relowered) - calls} times")
            if not np.array_equal(pa.raw, pb.raw):
                raise AssertionError(f"[options] {label}: A and B differ in "
                                     f"{int((pa.raw != pb.raw).sum())} rows")
            if ("overlap_host_ms" not in t
                    or "overlap_host_ms" in rb.timings_ms
                    or t.get("subsolve_ms", 0.0) + t["overlap_host_ms"]
                    > t["anneal_ms"]):
                raise AssertionError(f"[options] {label}: timings {t}")
            rows.append(dict(
                round=rnd, burst=label, order="".join(walls),
                wall_a_ms=round(wall_a, 3), wall_b_ms=round(wall_b, 3),
                relower_ms=round(relower_ms, 3),
                hidden_ms=round(wall_b + relower_ms - wall_a, 3),
                overlap_host_ms=round(t["overlap_host_ms"], 3),
                # the same with the re-lowering's time inside A's call,
                # which varies less than a second lowering's
                hidden_in_call_ms=round(
                    wall_b + t["overlap_host_ms"] - wall_a, 3),
                subsolve=(ra.subsolve or {}).get("outcome"),
                subsolve_ms=round(t.get("subsolve_ms", 0.0), 3),
                sweeps=ra.steps))
            print(f"[options] {json.dumps(rows[-1])}", flush=True)
    if len({(x.S, x.N) for x in relowered}) != 1:
        raise AssertionError("[options] the re-lowerings differ in shape")
    bursts = {}
    for label in dict.fromkeys(r["burst"] for r in rows):
        mine = [r for r in rows if r["burst"] == label]
        bursts[label] = {k: spread(np, [r[k] for r in mine]) for k in (
            "wall_a_ms", "wall_b_ms", "relower_ms", "overlap_host_ms",
            "hidden_ms", "hidden_in_call_ms")}
        print(f"[options] {json.dumps(dict(burst=label, rounds=len(mine), **bursts[label]))}",
              flush=True)
    since = tally_size(_ext, pt.S, pt.N)

    # (b) the sharded path: the callable and the proposal width
    spt = sharded_fleet(lower, SHARDED_SHAPE)
    mesh = sharded.Mesh([dev] * 8, (sharded.SVC_AXIS,))
    out = {}
    for tag, kw in (("plain", {}), ("overlap", dict(overlap_host_work=relower)),
                    ("width", dict(proposals_per_step=OPTIONS_WIDTH))):
        rp = sharded.ShardedResident(spt, mesh=mesh)
        t0 = time.perf_counter()
        res = sharded.solve_sharded(spt, resident=rp, steps=64, block=4,
                                    seed=0, **kw)
        torch.cuda.synchronize()
        out[tag] = res
        sharded_solve_row(res, spt, verify, dev_name, f"sharded_{tag}",
                          (time.perf_counter() - t0) * 1e3, tag="options",
                          width=res.proposals_per_step)
    if not (np.array_equal(out["plain"].assignment, out["overlap"].assignment)
            and out["plain"].soft == out["overlap"].soft
            and "overlap_host_ms" in out["overlap"].timings_ms):
        raise AssertionError("[options] solve_sharded with the callable "
                             "differs from the call without it")
    if (out["width"].proposals_per_step != OPTIONS_WIDTH
            or out["plain"].proposals_per_step == OPTIONS_WIDTH):
        raise AssertionError(f"[options] widths "
                             f"{out['plain'].proposals_per_step}, "
                             f"{out['width'].proposals_per_step}")
    since = tally_size(_ext, spt.S, spt.N, since)

    # (c) do_repair=False on the blocked instance: the adaptive anneal
    # (whose winner keeps only the stranded rows, which the repair cannot
    # move either) and the hot fixed budget (which the repair must mend)
    bpt = blocked_fleet(lower)
    rows_c = []
    for tag, kw in (("", {}), (" hot fixed", OPTIONS_HOT)):
        rows_c.append(unrepaired(
            np, solve(bpt, seed=0, do_repair=False, **kw), bpt, verify,
            solve(bpt, seed=0, **kw), repair, f"solve(){tag}",
            moves=bool(kw)))

    def lanes(do_repair):
        entries = []
        for seed in (0, 1):
            rp = ResidentProblem(bpt, dev)
            solve(bpt, prob=rp.prob, resident=rp, seed=seed, bucket=rp.bucket)
            entries.append(multiplex.MuxEntry(pt=bpt, resident=rp, seed=seed))
        return multiplex.solve_multiplexed(entries, do_repair=do_repair,
                                           device=dev)

    for j, (res, fixed) in enumerate(zip(lanes(False), lanes(True))):
        if res.telemetry is not None and res.telemetry["path"] != "mux":
            raise AssertionError("[options] the lanes did not batch")
        rows_c.append(unrepaired(np, res, bpt, verify, fixed, repair,
                                 f"solve_multiplexed lane {j}"))
    res, fixed = (sharded.solve_sharded(
        bpt, resident=sharded.ShardedResident(bpt, mesh=mesh), steps=64,
        block=4, seed=0, do_repair=flag) for flag in (False, True))
    rows_c.append(unrepaired(np, res, bpt, verify, fixed, repair,
                             "solve_sharded 1x8"))
    for row in rows_c:
        print(f"[options] {json.dumps(row)}", flush=True)
    tally_size(_ext, bpt.S, bpt.N, since)
    launches = read_launches(torch, _ext, "options",
                             ("k1_sweep", "k2_prerepair", "k3_rebuild",
                              "k4_greedy", "k7_sharded_sweep"),
                             off=("k6_greedy_scan",))
    took = time.perf_counter() - t_phase
    print(f"[options] {json.dumps(dict(phase_s=round(took, 3), budget_s=OPTIONS_BUDGET_S, over_budget=took > OPTIONS_BUDGET_S, rounds=OPTIONS_ROUNDS, hidden_ms={k: v['hidden_ms']['median'] for k, v in bursts.items()}, hidden_in_call_ms={k: v['hidden_in_call_ms']['median'] for k, v in bursts.items()}, relower_ms={k: v['relower_ms']['median'] for k, v in bursts.items()}, card=card))}",
          flush=True)
    return launches


def run_entry_phase(torch, mods, lower, dev):
    """[entry]: fn(*args) of entry() on the card: a 32-sweep anneal of 8
    chains of 256x16 (K1 launched 32 times) and the argmin of the chains'
    total cost, finite and no worse than the all-on-node-0 start."""
    _ext, entry, total_cost, problem = mods
    fn, args = entry()
    torch.cuda.synchronize()
    _ext.reset_launches()
    t_fn = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_fn) * 1e3
    # entry()'s fleet (prepare_problem makes no kernel launch)
    prob = problem.prepare_problem(lower.synthetic_problem(256, 16, seed=0),
                                   dev)
    launches = read_launches(torch, _ext, "entry", ("k1_sweep", "k3_rebuild"),
                             off=("k2_prerepair", "k4_greedy", "k5_subsolve",
                                  "k6_greedy_scan"), size=(prob.S, prob.N))
    if launches["k1_sweep"] != 32:
        raise AssertionError(f"[entry] K1 launched {launches['k1_sweep']} "
                             f"times, expected 32")
    cost = float(total_cost(prob, out))
    zero = float(total_cost(prob, torch.zeros(256, dtype=torch.int32,
                                              device=dev)))
    if out.shape != (256,) or not math.isfinite(cost) or cost > zero:
        raise AssertionError(f"[entry] {tuple(out.shape)}, cost {cost}, "
                             f"zero start {zero}")
    # the bound of the step: the anneal's K3 build, 32 K1 sweeps and
    # total_cost's K3 with stats (anneal.anneal + kernels.total_cost), then
    # the argmin over the chains' costs (entry)
    from fleetflow_tpu_torch.entry import ENTRY_CHAINS, ENTRY_STEPS
    from fleetflow_tpu_torch.solver.anneal import default_proposals_per_step
    C, M = ENTRY_CHAINS, default_proposals_per_step(prob.S)
    k1 = bound_of(C * M * sweep_prop_bytes(prob.conflict_ids.shape[1],
                                           prob.coloc_ids.shape[1])
                  + C * 4.0, C * M * 120.0)[0]
    k3 = (bound_of(k3_bytes(prob, C, stats=False), 0.0)[0]
          + bound_of(k3_bytes(prob, C), 0.0)[0])
    step = k3 + ENTRY_STEPS * k1
    argmin = bound_of(4.0 * C + 4.0, float(C))[0]
    print(f"[entry] 8 chains x 32 sweeps of 256x16: {wall:.3f} ms, best "
          f"total cost {cost:.6f} (zero start {zero:.6f}); bound: 2 K3 "
          f"{k3:.3g} + {ENTRY_STEPS} K1 of {k1:.3g} = {step:.3g} ms "
          f"(anneal + total_cost), + argmin {argmin:.3g} = "
          f"{step + argmin:.3g} ms (entry)", flush=True)
    return launches


def sharded_fleet(lower, shape):
    """The sharded phases' fleet at `shape`, the bench child's generator
    arguments, made once and kept in the checkout's fleet cache, which
    fleetflow_tpu_torch/tools/k67_profile.py reads in its own
    interpreter ([device], [phases])."""
    from fleetflow_tpu_torch.tools import k67_profile
    return k67_profile.cached_fleet(
        lower, f"{shape[0]}x{shape[1]}",
        lambda lw: k67_profile.sharded_fleet(lw, shape))


LAYOUT_KEYS = ("ms", "ms_t1", "device_ms", "host_ms", "plain_ms", "bound_ms",
               "bound_by", "max_abs_err", "S", "N", "applied")


def k7_against_plain(torch, mods, prob, seed, R: int, D: int,
                     label: str) -> dict:
    """K7 against sharded_step_plain on the staging `prob` over an RxD
    one-card mesh, from the (S,) assignment `seed` on the card: 8 sweeps
    of the warm schedule (t0 0.1) with the same draws, through one bound
    launcher as anneal_sharded binds it, equal applied counts,
    assignments and integer planes, loads within LOAD_RTOL, at least one
    move applied; a sweep's CUDA-event ms as the loop launches it at the
    schedule's start and end temperatures, the launcher's host ms (the
    call returns after the launch), the plain version's ms and the bound.
    Returns the layout's record ([device] adds its device ms)."""
    sharded, anneal = mods
    dev = prob.device
    torch.use_deterministic_algorithms(True, warn_only=True)
    base = anneal.chain_states_from_assignment(
        prob, seed.to(torch.int32).reshape(1, prob.S).expand(R, prob.S))
    M = max(8, min(256, (prob.S // D) // 2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    draws_src = sharded.TorchDraws(gen)
    sched = sharded._Schedule(0.1, 1e-3, 64, 1.3, R, True)
    st_k, st_p = base.clone(), base.clone()
    sweep = sharded.sweep_launcher(prob, st_k, D, M)
    draws, applied = [], 0
    for i in range(8):
        d = draws_src.proposals(i, sharded._hot(prob, st_k, D), prob.N, M)
        draws.append(d)
        acc_k = sweep(*d, sched.temps(i))
        _, acc_p = sharded.sharded_step_plain(prob, st_p, *d,
                                              sched.temps(i))
        if not torch.equal(acc_k, acc_p):
            raise AssertionError(f"K7 {label} applied counts differ at "
                                 f"sweep {i}")
        applied += int(acc_k.sum())
    torch.cuda.synchronize()
    for name in ("assignment", "used", "coloc", "topo"):
        if not torch.equal(getattr(st_k, name), getattr(st_p, name)):
            raise AssertionError(f"K7 {label} {name} differs")
    err = max_err(torch, st_k.load, st_p.load)
    if not torch.allclose(st_k.load, st_p.load, rtol=LOAD_RTOL, atol=0):
        raise AssertionError(f"K7 {label} load differs by {err}")
    if applied == 0:
        raise AssertionError(f"K7 {label} applied no move in 8 sweeps")
    s_loc, b_idx, u = draws[0]
    temps = sched.temps(0)

    def bound():
        return (sharded.sweep_launcher(prob, base.clone(), D, M),)

    ms, ms_t1 = (cuda_ms(torch, lambda sw, t=t: sw(s_loc, b_idx, u, t),
                         setup=bound, reps=20)
                 for t in (temps, sched.temps(63)))
    host = []
    with as_deployed(torch):
        for _ in range(20):
            (sw,) = bound()
            torch.cuda.synchronize()
            t_call = time.perf_counter()
            sw(s_loc, b_idx, u, temps)
            host.append((time.perf_counter() - t_call) * 1e3)
    host_ms = statistics.median(host)
    plain = cuda_ms(torch, lambda st: sharded.sharded_step_plain(
        prob, st, s_loc, b_idx, u, temps), setup=lambda: (base.clone(),))
    torch.use_deterministic_algorithms(False)
    # each proposal's rows (as K1's) and the replicas' topology counts
    per_prop = sweep_prop_bytes(prob.conflict_ids.shape[1],
                                prob.coloc_ids.shape[1],
                                prob.preferred is not None)
    props = R * D * M
    t_bytes = props * per_prop + 4.0 * R * prob.T
    t_ops = props * 120.0
    t_bound, by = bound_of(t_bytes, t_ops)
    print(f"[k7] {label}: S {prob.S} (n_real {prob.real_rows}), N {prob.N}, "
          f"{props} proposals a sweep: 8 sweeps equal ({applied} moves), "
          f"load max |err| {err:.3g}; a sweep through the bound launcher: "
          f"event {ms:.4f} ms at t0, {ms_t1:.4f} ms at t1, host "
          f"{host_ms:.4f} ms (device ms: [device]); plain {plain:.3f} ms, "
          f"bound {t_bound:.3g} ms ({by})", flush=True)
    return dict(ms=ms, ms_t1=ms_t1, device_ms=None, host_ms=host_ms,
                plain_ms=plain, bound_ms=t_bound, bound_by=by,
                max_abs_err=err, S=prob.S, N=prob.N, applied=applied,
                bytes=t_bytes, ops=t_ops)


def check_k7(torch, np, mods, lower, dev):
    """[k7]: K7 against sharded_step_plain on one-card meshes of 1x8 and
    2x4 positions at the sharded fleet, staged by pad_problem: the
    partitioned seed with 5% of the nodes killed (k7_against_plain).
    Returns the kernel record (the 1x8 layout's numbers, both layouts
    under "layouts"; [sharded] adds the stagings of its solves)."""
    sharded, problem, buckets, greedy, anneal = mods
    pt = sharded_fleet(lower, SHARDED_SHAPE)
    rng = np.random.default_rng(7)
    valid = pt.node_valid.copy()
    valid[rng.choice(pt.N, int(0.05 * pt.N), replace=False)] = False
    layouts = {}
    for R, D in ((1, 8), (2, 4)):
        prob = problem.prepare_problem(pt, dev)
        prob, orig = buckets.pad_problem(prob, D)
        prob = dataclasses.replace(
            prob, n_real=orig,
            node_valid=torch.tensor(valid, device=dev))
        seed = buckets.pad_assignment(greedy.partitioned_seed(pt, D),
                                      prob.S, valid)
        layouts[f"{R}x{D}"] = k7_against_plain(
            torch, (sharded, anneal), prob, torch.tensor(seed, device=dev),
            R, D, f"{R}x{D} on one card")
    head = layouts["1x8"]
    return dict(
        name="k7_sharded_sweep", route="cuda",
        source="fleetflow_tpu_torch/csrc/k7_sharded_sweep.cu",
        replaces="fleetflow_tpu/solver/sharded.py:443",
        max_abs_err=max(v["max_abs_err"] for v in layouts.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], library_ms=None,
        ops=head["ops"], bytes=head["bytes"],
        layouts={k: {f: v[f] for f in LAYOUT_KEYS}
                 for k, v in layouts.items()})


def sharded_solve_row(res, pt_now, verify, dev_name: str, label: str,
                      wall_ms: float, tag: str = "sharded", **extra) -> dict:
    """A [sharded] solve checked as every phase's are (feasible, the host
    verify agrees, no host repair, nothing on a dead node, on the card),
    and its report line."""
    check_solve(res, pt_now, verify, dev_name, label)
    t = res.timings_ms
    row = dict(solve=label, wall_ms=round(wall_ms, 3), sweeps=res.steps,
               soft=round(res.soft, 6),
               swaps=f"{res.tempering['swap_accepts']}/"
                     f"{res.tempering['swap_attempts']}",
               mesh=res.telemetry["mesh"] if res.telemetry else None,
               padded_S=res.bucket["padded_S"],
               warm_h2d_copies=res.warm_h2d_copies, **extra,
               timings_ms={k: round(v, 3) for k, v in t.items()})
    print(f"[{tag}] {json.dumps(row)}", flush=True)
    return row


def run_sharded_phase(torch, np, mods, lower, dev, recs):
    """[sharded]: the pod path on one card. (a) a cold solve_sharded of the
    sharded fleet over a 1x8 mesh (steps 64, block 4, the bench child's
    settings); (b) the bench's resident leg on a 2x4 tempering mesh: a
    cold solve, an untimed warm-up burst, then SHARDED_BURSTS bursts (the
    busiest node killed, the node killed two bursts before revived)
    through apply_delta + a resident-warm solve_sharded, and one more
    burst under torch.profiler with no host-to-device copy in its
    fleet.sharded range; (c) the XL fleet cold over a 1x8 mesh. K7 and K3
    must launch, no other kernel. Then, once the counts are read, K3 is
    held against its plain version on the cold 1x8 and XL stagings from
    their winners (k3_against_plain, a `sizes` entry each in `recs`), and
    K7 on each of these stagings from its resident winner
    (k7_against_plain). Returns the launch counts and K7's layouts'
    records."""
    _ext, sharded, anneal, kernels, verify, ProblemDelta = mods
    dev_name = str(dev)
    positions = [dev] * 8
    pt = sharded_fleet(lower, SHARDED_SHAPE)
    torch.cuda.synchronize()
    _ext.reset_launches()

    def cold(pt_now, mesh, label, seed=0):
        rp = sharded.ShardedResident(pt_now, mesh=mesh)
        t_solve = time.perf_counter()
        res = sharded.solve_sharded(pt_now, resident=rp, steps=64, block=4,
                                    seed=seed)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_solve) * 1e3
        return rp, res, sharded_solve_row(res, pt_now, verify, dev_name,
                                          label, wall)

    rp_cold, _res, _row = cold(
        pt, sharded.Mesh(positions, (sharded.SVC_AXIS,)), "cold_1x8")

    rp, prev, _row = cold(pt, sharded.tempering_mesh(2, 4, devices=positions),
                          "resident_cold_2x4", seed=70)
    dead: deque = deque()
    valid = pt.node_valid.copy()

    def burst(label, seed, run=None):
        nonlocal valid, pt, prev
        victim = int(busiest(np, prev.assignment, valid, 1)[0])
        valid = valid.copy()
        valid[victim] = False
        if len(dead) >= 2:
            valid[dead.popleft()] = True
        dead.append(victim)
        cur = dataclasses.replace(pt, node_valid=valid.copy())

        def solve_burst():
            delta_ms = rp.apply_delta(cur, ProblemDelta(
                node_valid=valid.copy()))
            res = sharded.solve_sharded(cur, resident=rp,
                                        resident_warm=True, steps=64,
                                        block=4, seed=seed)
            torch.cuda.synchronize()
            return delta_ms, res

        t_burst = time.perf_counter()
        delta_ms, res = solve_burst() if run is None else run(solve_burst)
        wall = (time.perf_counter() - t_burst) * 1e3
        if res.warm_h2d_copies:
            raise AssertionError(f"{label}: {res.warm_h2d_copies} uploads "
                                 f"in the warm dispatch")
        pt, prev = cur, res
        return sharded_solve_row(res, cur, verify, dev_name, label, wall,
                                 delta_stage_ms=round(delta_ms, 3),
                                 killed=victim)

    burst("warmup_burst", 71)
    rows = [burst(f"burst:{i}", 80 + i) for i in range(SHARDED_BURSTS)]
    walls = sorted(r["wall_ms"] for r in rows)
    print(f"[sharded] resident leg 2x4: {SHARDED_BURSTS} bursts, wall ms "
          f"min {walls[0]:.3f} median {statistics.median(walls):.3f} max "
          f"{walls[-1]:.3f}", flush=True)
    def attempt(i):
        box = {}

        def under_profiler(solve_burst):
            out, box["prof"] = auditor().profiled(solve_burst)
            return out

        burst("burst_profiled" + (f":{i}" if i else ""), 90 + i,
              run=under_profiler)
        return box["prof"]

    no_h2d_in_dispatch(attempt, sharded.SHARDED_RANGE, "sharded")
    # the sharded merge alone, on the last burst's uploads (a repeat of
    # the same merge changes nothing): the node planes copied, the
    # phantom rows re-parked
    up = rp.merge_inputs(pt, ProblemDelta(node_valid=valid.copy()))
    first_valid = int(np.argmax(up["valid_np"]))
    m_ms = cuda_ms(torch, lambda: sharded.merge_sharded(
        rp.prob, rp.assignment, up["node_valid"], up["capacity"],
        first_valid=first_valid))
    N, phantoms = rp.prob.N, rp.prob.S - rp.prob.real_rows
    m_bound = bound_of(2.0 * (N + 12 * N) + 4.0 * phantoms, 0.0)
    print(f"[sharded] merge_sharded (node planes, {phantoms} phantom rows "
          f"re-parked): {m_ms:.3f} ms, bound {m_bound[0]:.3g} ms "
          f"({m_bound[1]})", flush=True)

    since = tally_size(_ext, pt.S, pt.N)
    pt_xl = sharded_fleet(lower, XL_SHAPE)
    torch.cuda.reset_peak_memory_stats()
    rp_xl, res, row = cold(pt_xl, sharded.Mesh(positions, (sharded.SVC_AXIS,)),
                           "xl_cold_1x8")
    per_dev = sharded.per_device_bytes(rp_xl.prob, rp_xl.mesh, state=True)
    print(f"[sharded] xl {XL_SHAPE[0]}x{XL_SHAPE[1]}: per_device_bytes "
          f"{json.dumps(per_dev)} (sum {sum(per_dev.values())}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()}",
          flush=True)
    tally_size(_ext, pt_xl.S, pt_xl.N, since=since)
    launches = read_launches(torch, _ext, "sharded",
                             ("k7_sharded_sweep", "k3_rebuild"),
                             off=("k1_sweep", "k2_prerepair", "k4_greedy",
                                  "k5_subsolve", "k6_greedy_scan"))
    # K3 and K7 at the shapes this path gave them: the bucketed stagings
    # with their phantom rows (the resident one after its bursts, dead
    # nodes and all) and the XL occupancy plane; these launches are not
    # the path's
    for label, r in (("cold_1x8", rp_cold), ("xl_cold_1x8", rp_xl)):
        k3_against_plain(torch, kernels, r.prob, r.assignment[None],
                         f"{r.prob.S}x{r.prob.N} sharded {label}", recs,
                         "winner")
    layouts = {}
    for label, r in (("sharded cold_1x8", rp_cold),
                     ("sharded resident_2x4", rp),
                     ("sharded xl_cold_1x8", rp_xl)):
        layouts[label] = k7_against_plain(
            torch, (sharded, anneal), r.prob, r.assignment,
            r.mesh.shape.get(sharded.REPLICA_AXIS, 1),
            r.mesh.shape[sharded.SVC_AXIS], label)
    return launches, layouts


def run_dryrun_phase(torch, _ext, dryrun_multichip):
    """[dryrun]: entry.dryrun_multichip(8) on 8 positions of the card:
    the chain layout (K1, K3), S=64 over 8 shards and the ragged 61x8
    fleet over 8 shards (K7) reaching 0 violations."""
    torch.cuda.synchronize()
    _ext.reset_launches()
    t_run = time.perf_counter()
    out = dryrun_multichip(8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) * 1e3
    print(f"[dryrun] {json.dumps(dict(out, wall_ms=round(wall, 3)))}",
          flush=True)
    # tallied under the chain layout's fleet, synthetic_problem(64, 8)
    return read_launches(torch, _ext, "dryrun",
                         ("k1_sweep", "k3_rebuild", "k7_sharded_sweep"),
                         off=("k2_prerepair", "k4_greedy", "k5_subsolve",
                              "k6_greedy_scan"), size=(64, 8))


# -- [ranks]: the ranks of a process group sharing the card --------------------

RANKS_N = 4                # worker processes, each a rank on the one card
RANKS_BUDGET_S = 90.0      # the phase's time on the card's host
RANKS_RENDEZVOUS_S = 60.0  # init_multihost's rendezvous timeout
RANKS_TIMEOUT_S = 300.0    # the workers' whole run
RANKS_SWEEPS = 8           # check 1: sweeps of the 2x2 tempered anneal
RANKS_CHAINS = 8           # check 3: solve(mesh=) chains
RANKS_SCHED_CHAINS = 4     # check 3: the scheduler's chains, one a rank
RANKS_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "ranks")
RANK_ENTRIES = ("k7_rank_elect", "k7_rank_apply", "k7_rank_reduce")
RANK_REPLACES = {"k7_rank_elect": "fleetflow_tpu/solver/sharded.py:468",
                 "k7_rank_apply": "fleetflow_tpu/solver/sharded.py:487",
                 "k7_rank_reduce": "fleetflow_tpu/solver/sharded.py:497"}
RANK_ENV = ("FLEET_COORD", "FLEET_NUM_PROCS", "FLEET_PROC_ID", "RANK",
            "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


class RecordedDraws:
    """A draw object that records what the one-card run drew (with the hot
    masks it was handed), or replays such a record on a rank: the rank's
    position's hot mask must be the recorded one (it walks the recorded
    path)."""

    def __init__(self, inner=None, record=None, position=None, device=None):
        self.inner, self.position, self.device = inner, position, device
        self.props = [] if record is None else list(record["proposals"])
        self.swaps = [] if record is None else list(record["exchange"])

    def proposals(self, sweep, hot, N, M):
        if self.inner is not None:
            out = self.inner.proposals(sweep, hot, N, M)
            self.props.append((hot.cpu(), *(x.cpu() for x in out)))
            return out
        want_hot, s, b, u = self.props.pop(0)
        r, d = self.position
        if not bool((hot[r, d].cpu() == want_hot[r, d]).all()):
            raise AssertionError(f"[ranks] sweep {sweep}: position ({r}, "
                                 f"{d}) left the recorded path")
        return tuple(x.to(self.device) for x in (s, b, u))

    def exchange(self, R, device):
        if self.inner is not None:
            u = self.inner.exchange(R, device)
            self.swaps.append(u.cpu())
            return u
        return self.swaps.pop(0).to(device)

    def record(self) -> dict:
        return {"proposals": self.props, "exchange": self.swaps}


def to_device(torch, obj, dev):
    """A TorchProblem or ChainState with its tensors on `dev`."""
    if isinstance(obj, tuple):
        return type(obj)(*(t.to(dev) for t in obj))
    from fleetflow_tpu_torch.solver.problem import TENSOR_FIELDS
    return dataclasses.replace(obj, **{
        n: t.to(dev) for n, t in zip(TENSOR_FIELDS, obj.tensors())
        if t is not None})


def ranks_worker(directory: str) -> int:
    """One rank of [ranks] (``chip_smoke.py --ranks-worker DIR`` with the
    FLEET_* rendezvous in its environment): joins the group on the card
    with gloo, finds the kernels built, runs the three checks' main path
    and writes DIR/result-<rank>.pt; its launch counts go to
    FLEET_LAUNCH_DIR at its exit."""
    import numpy as np
    import torch

    from fleetflow_tpu_torch import _ext, parallel
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.solver import collectives, sharded, sharded_ranks
    from fleetflow_tpu_torch.solver.api import solve
    from fleetflow_tpu_torch.solver.resident import ProblemDelta

    t_start = time.perf_counter()
    case = torch.load(os.path.join(directory, "case.pt"), weights_only=False)
    dev = torch.device(case["device"])
    parallel.init_multihost(device=dev, backend="gloo",
                            timeout=RANKS_RENDEZVOUS_S)
    w = parallel.world()
    build_s = _ext.build() if dev.type == "cuda" else 0.0
    out = {"rank": w.rank, "build_s": build_s, "steps_ms": {},
           "init_s": time.perf_counter() - t_start}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["steps_ms"][name] = (time.perf_counter() - t0) * 1e3
        return res

    # 1. the 2x2 tempered anneal from the one-card run's state and draws
    mesh = sharded.tempering_mesh(2, 2)
    r, d = mesh.position
    a = case["anneal"]
    lp = sharded.shard_problem(to_device(torch, a["prob"], dev), mesh)
    S_loc = lp.S
    one = a["init_state"]
    st = type(one)(one.assignment[r:r + 1, d * S_loc:(d + 1) * S_loc]
                   .to(dev).contiguous(),
                   *(t[r:r + 1].to(dev).contiguous() for t in one[1:]))
    sharded_ranks.SWEEP_EVENTS = events = []
    collectives.reset_stats()
    try:
        res = step("anneal", lambda: sharded.anneal_sharded(
            lp, None, draws=RecordedDraws(record=a["record"],
                                          position=(r, d), device=dev),
            init_state=st, mesh=mesh, steps=RANKS_SWEEPS, t0=0.1, block=4,
            n_real=a["n_real"], return_stats=True))
    finally:
        sharded_ranks.SWEEP_EVENTS = None
    torch.cuda.synchronize()
    sweeps = [{name: marks[i - 1][1].elapsed_time(ev)
               for i, (name, ev) in enumerate(marks) if i}
              for marks in events]
    out["anneal"] = dict(assignment=res.assignment.cpu(),
                         planes=[t.cpu() for t in st], sweeps=sweeps,
                         swaps=(res.swap_attempts, int(res.swap_accepts)),
                         collectives={k: list(v) for k, v
                                      in collectives.STATS.items()})

    # 2. solve_sharded cold and three warm bursts
    pt = case["fleet"]
    rp = sharded.ShardedResident(pt, mesh=mesh)
    solves = []

    def record(label, res, pt_now):
        solves.append(dict(
            label=label, assignment=res.assignment, violations=res.violations,
            pre=res.pre_repair_violations, moves=res.moves_repaired,
            h2d=res.warm_h2d_copies, sweeps=res.steps,
            on_dead=int((~pt_now.node_valid[res.assignment]).sum()),
            device=res.device, tempering=res.tempering,
            timings=dict(res.timings_ms)))

    prev = step("sharded_cold", lambda: sharded.solve_sharded(
        pt, resident=rp, steps=64, block=4, seed=0))
    record("cold", prev, pt)
    rng = np.random.default_rng(23)
    for i, kind in enumerate(("kill1", "kill5pct", "arrive64")):
        valid = pt.node_valid.copy()
        if kind == "kill1":
            valid[busiest(np, prev.assignment, valid, 1)] = False
            cur, delta = dataclasses.replace(pt, node_valid=valid), \
                ProblemDelta(node_valid=valid.copy())
        elif kind == "kill5pct":
            live = np.flatnonzero(valid)
            valid[rng.choice(live, int(0.05 * pt.N), replace=False)] = False
            cur, delta = dataclasses.replace(pt, node_valid=valid), \
                ProblemDelta(node_valid=valid.copy())
        else:
            cur, d_kw = with_arrivals(np, pt, ARRIVALS, rng)
            delta = ProblemDelta(**d_kw)
            if not rp.compatible(cur, delta):
                raise AssertionError("[ranks] the arrivals do not fit the "
                                     "phantom rows")
        rp.apply_delta(cur, delta)
        prev = step(f"sharded_{kind}", lambda cur=cur: sharded.solve_sharded(
            cur, resident=rp, resident_warm=True, steps=64, block=4,
            seed=1 + i))
        record(kind, prev, cur)
        pt = cur
    # one more one-node burst under torch.profiler on rank 0 (its warm
    # dispatch range read for host-to-device copies)
    valid = pt.node_valid.copy()
    valid[busiest(np, prev.assignment, valid, 1)] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy()))

    def burst():
        return sharded.solve_sharded(cur, resident=rp, resident_warm=True,
                                     steps=64, block=4, seed=9)

    if w.rank == 0:
        prev, prof = auditor().profiled(burst, dev)
        seen = auditor().probe_seen(prof, sharded.SHARDED_RANGE)
        traffic = auditor().host_traffic_in_range(prof, sharded.SHARDED_RANGE)
        out["profiled"] = dict(seen=None if seen is None else seen[0],
                               ranges=traffic["ranges"], ops=traffic["ops"],
                               h2d=traffic["h2d"])
    else:
        prev = burst()
    record("profiled", prev, cur)
    out["sharded"] = solves
    out["memory"] = dict(
        max_allocated=torch.cuda.max_memory_allocated(dev),
        per_device_bytes=sum(sharded.per_device_bytes(
            rp.prob, rp.mesh, state=True).values()))

    # 3. the chain mesh at the headline: solve(mesh=), then the scheduler
    hl = case["headline"]
    mesh4 = parallel.chain_mesh()
    res = step("chain_solve", lambda: solve(hl, mesh=mesh4,
                                            chains=RANKS_CHAINS, seed=0))
    out["chain"] = dict(assignment=res.assignment, stats=res.stats,
                        soft=res.soft, steps=res.steps, device=res.device,
                        accepted=res.accepted_moves)
    sched = GpuSolverScheduler(mesh=mesh4, chains=RANKS_SCHED_CHAINS)
    first = step("sched_cold", lambda: sched.place(hl, stage="t0"))
    valid = hl.node_valid.copy()
    valid[busiest(np, first.raw, valid, 1)] = False
    again = step("sched_kill1", lambda: sched.reschedule(
        dataclasses.replace(hl, node_valid=valid),
        delta=ProblemDelta(node_valid=valid.copy()), stage="t0"))
    out["sched"] = [dict(raw=p.raw, feasible=p.feasible, soft=p.soft,
                         source=p.source, violations=p.violations)
                    for p in (first, again)]
    out["seconds"] = time.perf_counter() - t_start
    torch.cuda.synchronize()
    path = os.path.join(directory, f"result-{w.rank}.pt")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)
    parallel.shutdown()
    return 0


def rank_entry_bytes(prob, M: int, T: int, D: int, words: int,
                     moved: dict) -> dict:
    """(bytes, operations) each cross-rank entry point must move and do
    for one position of this run; `moved` holds a position's mean applied
    moves ("applied") and node entries ("entries") and a replica's mean
    moves, id cells, node entries and distinct touched nodes
    ("replica_applied", "replica_ids", "replica_entries",
    "replica_nodes"): elect reads its M proposals' rows (as a K7
    proposal) and the topology counts and writes (4, M) ints; apply reads
    the (4, M) ints and the slots of the targets, and for each applied
    move its demand and id rows, writes its assignment and the position's
    records (every one of their `words` ints); reduce reads the D gathered
    records' headers, move rows and node entries, reads and writes the
    two cells of each id (and of the topology) a move changes ("ids"
    counts a move's ids and its topology once each), writes the
    slot of each move's target, reads and writes each touched node's load.
    The clustered elect and apply read and write the same inputs and
    outputs; their own scratch (elect's `first`, apply's list in shared
    memory, reduce's node accumulator) is no input or output of the
    function and is not counted."""
    K, Kc = prob.conflict_ids.shape[1], prob.coloc_ids.shape[1]
    per_prop = sweep_prop_bytes(K, Kc, prob.preferred is not None)
    elect = (M * per_prop + 4.0 * T + 16.0 * M, M * 120.0)
    apply = (16.0 * M + 4.0 * M
             + moved["applied"] * (12.0 + 4.0 * (K + Kc) + 4.0)
             + 4.0 * words, moved["applied"] * 24.0)
    reduce = (16.0 * D
              + moved["replica_applied"] * (4.0 * (3 + K + Kc) + 4.0)
              + moved["replica_ids"] * 16.0
              + moved["replica_entries"] * 16.0
              + moved["replica_nodes"] * 24.0,
              3.0 * (moved["replica_entries"] + moved["replica_nodes"]))
    return dict(zip(RANK_ENTRIES, (elect, apply, reduce)))


RANK_ADVERSARIAL = ("one_service", "one_target", "all_rejected",
                    "full_width")
RANK_HOT_TEMP = 50.0       # the adversarial sweeps' temperature
RANK_TIMED_SWEEPS = 30     # sweeps of one bound launcher, timed
RANK_PROBE = 1 << 15       # rank_widest's bisection: M in [1, this]


def rank_adversarial_draws(torch, case: str, assignment, D: int, N: int,
                           M: int, gen):
    """(s_loc, b_idx, u), each (R, D, M) on the device of `assignment`
    (the (R, S) replicas' assignment, S = D shards of S/D rows), of a case
    on which K7's cross-rank election and apply could go wrong; u uniform
    from `gen` (a generator on that device):
      one_service   every proposal of a position names one service (one
                    candidate out of many accepted proposals)
      one_target    every proposal targets node N // 2 (many candidates
                    for one slot in every position; the lowest rank over
                    the shards wins it)
      all_rejected  every proposal targets its service's own node
                    (rejected: nothing is a candidate, nothing applied)
      full_width    each position proposes its shard's last M rows once
                    each, in a random order (M <= S/D; with M = S/D every
                    row, the phantom rows among them), targets uniform."""
    R, S = assignment.shape
    S_loc = S // D
    dev = assignment.device
    shape = (R, D, M)
    u = torch.rand(shape, generator=gen, device=dev)
    b = torch.randint(0, N, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    s = torch.randint(0, S_loc, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    if case == "one_service":
        s = torch.randint(0, S_loc, (R, D, 1), generator=gen, device=dev,
                          dtype=torch.int32).expand(shape)
    elif case == "one_target":
        b = torch.full(shape, N // 2, dtype=torch.int32, device=dev)
    elif case == "all_rejected":
        rows = s.long() + (torch.arange(D, device=dev) * S_loc).view(1, D, 1)
        b = torch.gather(assignment.long(), 1, rows.reshape(R, -1)).reshape(
            shape).to(torch.int32)
    elif case == "full_width":
        if M > S_loc:
            raise ValueError(f"full_width: M {M} > S/D {S_loc}")
        s = torch.stack([S_loc - M + torch.randperm(M, generator=gen,
                                                    device=dev)
                         for _ in range(R * D)]).reshape(shape).to(
                             torch.int32)
    else:
        raise ValueError(f"unknown case {case!r}")
    return s.contiguous(), b.contiguous(), u.contiguous()


def rank_widest(sr, lp, st, pos, hi: int = RANK_PROBE) -> int:
    """The widest M ff_k7r_bind takes for the shard `lp` and its state
    `st` on the card: a bisection over binds in [1, hi] (a refusal raises
    KernelError; the binds are monotone in M)."""
    from fleetflow_tpu_torch.core.errors import KernelError
    ok, bad = 0, hi + 1
    while bad - ok > 1:
        mid = (ok + bad) // 2
        try:
            sr.rank_sweep(lp, st, pos, mid)
        except KernelError:
            bad = mid
        else:
            ok = mid
    return ok


def rank_positions(torch, sr, anneal, prob, n_real, one, R: int, D: int,
                   M: int, dev) -> dict:
    """{(r, d): (position, (shard, state, scratch) on `dev`, the same on
    the CPU)} of an R x D mesh over `prob`, each position's state its rows
    of the (R, S) replica state `one`."""
    S_loc = prob.S // D
    both = {}
    for r in range(R):
        for d in range(D):
            pos = sr.RankPosition(r, d, R, D, prob.S, d * S_loc)
            lp = sr.shard_rows(dataclasses.replace(prob, n_real=n_real), pos)
            st = anneal.ChainState(
                one.assignment[r:r + 1, d * S_loc:(d + 1) * S_loc]
                .to(dev, copy=True).contiguous(),
                *(t[r:r + 1].to(dev, copy=True).contiguous()
                  for t in one[1:]))
            st_c = anneal.ChainState(*(t.to("cpu", copy=True) for t in st))
            lp_c = to_device(torch, lp, "cpu")
            both[r, d] = (pos, (lp, st, sr.rank_scratch(lp, st, M)),
                          (lp_c, st_c, sr.rank_scratch(lp_c, st_c, M)))
    return both


def rank_sweep_vs_plain(torch, sr, both: dict, R: int, D: int, draws,
                        temps, same) -> dict:
    """One cross-rank sweep of every position, the entry points on the
    card and their plain versions on the CPU copies, the collectives done
    by hand (the slots' MIN over a replica's shards, the records gathered
    in shard order); `same(name, card, cpu)` compares each entry point's
    outputs: elect's slots, proposals and `first`, apply's records (entry
    for entry) and assignment, reduce's planes and the scratch back at
    rest. Returns the sums over the positions and replicas of the applied
    moves ("applied"), node entries ("entries"), id cells moved ("ids")
    and distinct touched nodes of each replica ("nodes")."""
    s_all, b_all, u_all = draws
    out = dict(applied=0, entries=0, ids=0, nodes=0)
    for (r, d), (pos, k, c) in both.items():
        args = tuple(x[r, d].contiguous() for x in (s_all, b_all, u_all))
        sr.sharded_elect(*k, pos, *args, temps[r])
        sr.sharded_elect_plain(*c, pos, *(x.cpu() for x in args), temps[r])
        same("k7_rank_elect", k[2].slots, c[2].slots)
        same("k7_rank_elect", k[2].cand, c[2].cand)
        same("k7_rank_elect", k[2].first, c[2].first)
    for r in range(R):
        for side in (1, 2):
            slots = torch.stack([both[r, d][side][2].slots
                                 for d in range(D)]).min(0).values
            for d in range(D):
                both[r, d][side][2].slots.copy_(slots)
    for (r, d), (pos, k, c) in both.items():
        sr.sharded_apply(*k, pos)
        sr.sharded_apply_plain(*c, pos)
        same("k7_rank_apply", k[2].records, c[2].records)
        same("k7_rank_apply", k[1].assignment, c[1].assignment)
    for r in range(R):
        gathered = {side: torch.stack([both[r, d][side][2].records
                                       for d in range(D)])
                    for side in (1, 2)}
        lp0, _st, sc0 = both[r, 0][2]
        cap, wm, _words = sr.record_layout(
            sc0.cand.shape[1], lp0.N, lp0.conflict_ids.shape[-1],
            lp0.coloc_ids.shape[-1])
        nodes = []
        for rec in gathered[2]:
            count, ent, mv = sr.record_views(rec, cap, wm)
            n = int(count[0])
            live = ent[:2 * n, 0]
            nodes.append(live[live >= 0])
            out["applied"] += n
            out["entries"] += int((live >= 0).sum())
            out["ids"] += int((mv[:n, 3:] >= 0).sum()) + int(
                (mv[:n, 2] > 0).sum())
        out["nodes"] += int(torch.cat(nodes).unique().numel())
        for d in range(D):
            pos = both[r, d][0]
            sr.sharded_reduce(*both[r, d][1], pos, gathered[1])
            sr.sharded_reduce_plain(*both[r, d][2], pos, gathered[2])
    for (r, d), (pos, k, c) in both.items():
        for x, y in zip(k[1], c[1]):
            same("k7_rank_reduce", x, y)
        same("k7_rank_reduce", k[2].slots,
             torch.full_like(c[2].slots, 2**31 - 1))
        same("k7_rank_reduce", k[2].acc, c[2].acc)  # at rest
    return out


def check_rank_entries(torch, mods, a: dict, dev) -> dict:
    """K7's cross-rank entry points against their plain versions at the
    shapes [ranks]' main path gives them: every position of the 2x2 mesh
    over the sharded fleet, its shard and its replica's state from the
    one-card run's initial state, the recorded draws of its first three
    sweeps, then from the same state one sweep of each adversarial case
    (RANK_ADVERSARIAL at RANK_HOT_TEMP; full_width at M = S/D, every row
    of the shard once, the phantom row among them, or at the widest M the
    bind takes if that is less), the collectives done by hand. Each entry
    point's outputs must equal its plain version's on CPU copies of the same inputs (max |err| 0). Each
    entry point is then timed as anneal_ranks launches it
    (tools/k7r_profile.py's entry_times on position (0, 0), the other
    position of its replica sweeping beside it, so reduce gets both
    positions' records), its plain version on the card with CUDA events
    on the same inputs; the bound counts what those timed sweeps moved.
    Returns each entry point's record."""
    sharded, sr, anneal = mods
    prob = to_device(torch, a["prob"], dev)
    R = D = 2
    S_loc = prob.S // D
    one = a["init_state"]
    M = max(8, min(256, S_loc // 2))
    err = {name: 0.0 for name in RANK_ENTRIES}
    sched = sharded._Schedule(0.1, 1e-3, RANKS_SWEEPS, 1.3, R, True)

    def same(name, x, y):
        if x.dtype.is_floating_point:
            err[name] = max(err[name], max_err(torch, x.cpu(), y))
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"[ranks] {name} differs from its plain "
                                 f"version: max |err| {max_err(torch, x.cpu(), y)}")

    both = rank_positions(torch, sr, anneal, prob, a["n_real"], one, R, D,
                          M, dev)
    applied = 0
    for i in range(3):
        _hot, s_all, b_all, u_all = a["record"]["proposals"][i]
        applied += rank_sweep_vs_plain(
            torch, sr, both, R, D, tuple(x.to(dev) for x in (s_all, b_all,
                                                              u_all)),
            sched.temps(i), same)["applied"]
    if applied == 0:
        raise AssertionError("[ranks] the entry points applied no move")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    whole = one.assignment.to(dev)
    pos0, (lp0, st0, _sc0), _cpu0 = both[0, 0]
    widest = rank_widest(sr, lp0, st0, pos0)
    print(f"[ranks] the widest M ff_k7r_bind takes at S/D {S_loc}: "
          f"{widest}", flush=True)
    for case in RANK_ADVERSARIAL:
        width = min(S_loc, widest) if case == "full_width" else M
        pb = rank_positions(torch, sr, anneal, prob, a["n_real"], one, R, D,
                            width, dev)
        draws = rank_adversarial_draws(torch, case, whole, D, prob.N, width,
                                       gen)
        got = rank_sweep_vs_plain(torch, sr, pb, R, D, draws,
                                  [RANK_HOT_TEMP] * R, same)
        if case == "all_rejected" and got["applied"]:
            raise AssertionError(f"[ranks] all_rejected applied "
                                 f"{got['applied']}")
        if case != "all_rejected" and not got["applied"]:
            raise AssertionError(f"[ranks] {case} applied no move")
        print(f"[ranks] adversarial {case}: M {width}, every 2x2 position's "
              f"elect, apply (its records entry for entry) and reduce equal "
              f"to the plain version on the CPU; {got['applied']} applied, "
              f"{got['entries']} node entries, {got['nodes']} touched nodes",
              flush=True)

    # timing on position (0, 0), the replica's other position sweeping
    # beside it: its shard and the one-card run's state
    pos, (lp, st0, _sc), _cpu = rank_positions(
        torch, sr, anneal, prob, a["n_real"], one, R, D, M, dev)[0, 0]
    whole = anneal.ChainState(*(t[:1].to(dev, copy=True).contiguous()
                                for t in one))
    from fleetflow_tpu_torch.tools import k7r_profile
    with as_deployed(torch):
        timed = k7r_profile.entry_times(
            torch, sr, sharded, dataclasses.replace(prob, n_real=a["n_real"]),
            whole, pos, M, RANK_TIMED_SWEEPS)
    _hot, s_all, b_all, u_all = a["record"]["proposals"][0]
    args = tuple(x[0, 0].to(dev).contiguous() for x in (s_all, b_all, u_all))
    temp = sched.temps(0)[0]
    st_r, gathered = timed["before_reduce"]

    def fresh(st=st0):
        st = anneal.ChainState(*(t.clone() for t in st))
        return lp, st, sr.rank_scratch(lp, st, M)

    def elected():
        k = fresh()
        sr.sharded_elect_plain(*k, pos, *args, temp)
        return k

    plain = {
        "k7_rank_elect": (lambda *k: sr.sharded_elect_plain(*k, pos, *args,
                                                            temp), fresh),
        "k7_rank_apply": (lambda *k: sr.sharded_apply_plain(*k, pos),
                          elected),
        "k7_rank_reduce": (lambda lp_, st_, sc_, g: sr.sharded_reduce_plain(
            lp_, st_, sc_, pos, g), lambda: (*fresh(st_r), gathered)),
    }
    # the bound from what the timed sweeps moved: the position's moves and
    # entries, the replica's in the gathered records reduce was given
    words = sr.record_layout(M, lp.N, lp.conflict_ids.shape[-1],
                             lp.coloc_ids.shape[-1])[2]
    mean = {k: statistics.mean(m[k] for m in timed["moved"])
            for k in timed["moved"][0]}
    per = rank_entry_bytes(lp, M, st0.topo.shape[-1], D, words, mean)
    recs = {}
    for name, (fn, setup) in plain.items():
        ms = statistics.median(timed[name]["event"])
        host_ms = statistics.median(timed[name]["host"])
        device_ms = timed[name]["device_ms"]
        plain_ms = cuda_ms(torch, fn, setup=setup, reps=5)
        t_bytes, t_ops = per[name]
        bound, by = bound_of(t_bytes, t_ops)
        recs[name] = dict(
            name=name, route="cuda",
            source="fleetflow_tpu_torch/csrc/k7_sharded_sweep.cu",
            replaces=RANK_REPLACES[name], max_abs_err=err[name], ms=ms,
            device_ms=device_ms, host_ms=host_ms, plain_ms=plain_ms,
            library_ms=None, bytes=t_bytes, ops=t_ops,
            adversarial=list(RANK_ADVERSARIAL))
        dev_txt = ("not measured" if device_ms is None
                   else f"{device_ms:.5f} ms")
        print(f"[ranks] {name}: S/D {lp.S} (global {prob.S}), N {lp.N}, M "
              f"{M}: 3 recorded sweeps and the {len(RANK_ADVERSARIAL)} "
              f"adversarial cases of every 2x2 position equal to the plain "
              f"version on the CPU (max |err| {err[name]}); as the loop "
              f"launches it ({RANK_TIMED_SWEEPS} sweeps of the replica, a "
              f"launcher a position): "
              f"event {ms:.5f} ms, device {dev_txt}, host {host_ms:.5f} "
              f"ms; plain on the card {plain_ms:.3f} ms, bound {bound:.3g} "
              f"ms ({by}, {t_bytes:.0f} B)", flush=True)
    return recs


def run_ranks_phase(torch, np, mods, lower, dev, card, pt_headline, recs):
    """[ranks]: RANKS_N worker processes (this script with
    --ranks-worker), each a rank of a gloo process group on the one card,
    placing on it. (1) a 2x2 tempered anneal_sharded of the sharded fleet
    across the ranks, RANKS_SWEEPS sweeps from the one-card 2x2 run's
    initial state with its recorded draws: the assignment and every
    replica plane bit-equal to that run's, each sweep's event ms by entry
    point and collective; (2) solve_sharded over the 2x2 ranks, cold and
    three warm bursts (one node down, 5% down, 64 arrivals into phantom
    rows), each feasible with nothing on a dead node and no host repair,
    every rank the same assignment, no counted upload in a warm dispatch
    and no host-to-device copy in a warm fleet.sharded range but the
    collectives' staging (rank 0 traced), each rank's peak allocation
    beside its shard's per_device_bytes; (3) at the headline fleet,
    solve(mesh=chain_mesh(), chains=8) equal bit for bit to the one-card
    solve, and GpuSolverScheduler(mesh=) cold and one node down equal to
    the one-card scheduler's (sub-solve off). Every rank's launches come
    through FLEET_LAUNCH_DIR; the three cross-rank entry points, K3, K4
    and K1 must launch. Then the entry points against their plain
    versions (check_rank_entries). NCCL is not exercised: one card."""
    (_ext, sharded, sr, problem, buckets, greedy, anneal, solve,
     GpuSolverScheduler, verify, ProblemDelta) = mods
    t_phase = time.perf_counter()
    os.makedirs(RANKS_DIR, exist_ok=True)
    launch_dir = os.path.join(RANKS_DIR, "launches")
    for folder in (RANKS_DIR, launch_dir):
        os.makedirs(folder, exist_ok=True)
        for name in os.listdir(folder):
            if name.endswith((".pt", ".json", ".tmp")):
                os.remove(os.path.join(folder, name))
    pt = sharded_fleet(lower, SHARDED_SHAPE)
    # (1)'s one-card run: the partitioned seed over 2 shards, its state,
    # its draws recorded
    prob, orig = buckets.pad_problem(problem.prepare_problem(pt, dev), 2)
    prob = dataclasses.replace(prob, n_real=orig)
    seed = torch.tensor(buckets.pad_assignment(
        greedy.partitioned_seed(pt, 2), prob.S, pt.node_valid), device=dev)
    st = anneal.chain_states_from_assignment(
        prob, seed.reshape(1, -1).expand(2, -1).contiguous())
    init_state = anneal.ChainState(*(t.to("cpu", copy=True) for t in st))
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    rec = RecordedDraws(inner=sharded.TorchDraws(gen))
    one = sharded.anneal_sharded(
        prob, None, draws=rec, init_state=st,
        mesh=sharded.tempering_mesh(2, 2, devices=[dev] * 4),
        steps=RANKS_SWEEPS, t0=0.1, block=4, return_stats=True)
    want_anneal = (one.assignment.cpu(), [t.cpu() for t in st])
    anneal_case = dict(prob=to_device(torch, prob, "cpu"), n_real=orig,
                       init_state=init_state, record=rec.record())
    # (3)'s one-card side
    want_chain = solve(pt_headline, device=dev, chains=RANKS_CHAINS, seed=0)
    with subsolve_off():
        sched = GpuSolverScheduler(chains=RANKS_SCHED_CHAINS, device=dev)
        first = sched.place(pt_headline, stage="t0")
        valid = pt_headline.node_valid.copy()
        valid[busiest(np, first.raw, valid, 1)] = False
        again = sched.reschedule(
            dataclasses.replace(pt_headline, node_valid=valid),
            delta=ProblemDelta(node_valid=valid.copy()), stage="t0")
    want_sched = (first, again)
    torch.save(dict(anneal=anneal_case, fleet=pt, headline=pt_headline,
                    device=str(dev)), os.path.join(RANKS_DIR, "case.pt"))
    t_ready = time.perf_counter()

    torch.cuda.synchronize()
    _ext.reset_launches()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env.update(FLEET_COORD=f"127.0.0.1:{port}",
               FLEET_NUM_PROCS=str(RANKS_N), FLEET_LAUNCH_DIR=launch_dir)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ranks-worker",
         RANKS_DIR], env=dict(env, FLEET_PROC_ID=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(RANKS_N)]
    deadline = time.perf_counter() + RANKS_TIMEOUT_S
    logs = [""] * RANKS_N
    try:
        for i, p in enumerate(procs):
            logs[i] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))[0]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[ranks] the workers ran past "
                             f"{RANKS_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    t_workers = time.perf_counter() - t_ready
    bad = [(i, p.returncode, logs[i][-4000:]) for i, p in enumerate(procs)
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"[ranks] workers failed: {bad}")
    results = [torch.load(os.path.join(RANKS_DIR, f"result-{i}.pt"),
                          weights_only=False) for i in range(RANKS_N)]
    counts = child_launches(launch_dir)
    need = (*RANK_ENTRIES, "k3_rebuild", "k4_greedy", "k1_sweep")
    if any(counts[k] == 0 for k in need) or \
            counts["k7_sharded_sweep"] or _ext.LAUNCHES["k7_sharded_sweep"]:
        raise AssertionError(f"[ranks] launches {counts}: expected all of "
                             f"{need}, not the one-card K7")
    print(f"[ranks] launches {json.dumps(counts)} (the {RANKS_N} ranks, "
          f"through FLEET_LAUNCH_DIR)", flush=True)
    tally = BY_SIZE.setdefault(size_label(*SHARDED_SHAPE), {})
    for k in KERNEL_NAMES:
        tally[k] = tally.get(k, 0) + counts[k]

    # (1)
    for res in results:
        got = res["anneal"]
        if not torch.equal(got["assignment"], want_anneal[0]):
            raise AssertionError(f"[ranks] rank {res['rank']}: the 2x2 "
                                 f"anneal's assignment differs from the "
                                 f"one-card run's")
        r, d = divmod(res["rank"], 2)
        S_loc = prob.S // 2
        planes = got["planes"]
        if not torch.equal(planes[0][0], want_anneal[1][0][
                r, d * S_loc:(d + 1) * S_loc]) or not all(
                torch.equal(x[0], y[r])
                for x, y in zip(planes[1:], want_anneal[1][1:])):
            raise AssertionError(f"[ranks] rank {res['rank']}: a replica "
                                 f"plane differs from the one-card run's")
        for i, ms in enumerate(got["sweeps"]):
            print(f"[ranks] anneal rank {res['rank']} sweep {i}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
                  flush=True)
        print(f"[ranks] anneal rank {res['rank']}: {RANKS_SWEEPS} sweeps "
              f"bit-equal to the one-card 2x2 K7 run (assignment, load, "
              f"occupancy, topology), swaps {got['swaps']}, collectives "
              f"(calls, host ms) {json.dumps(got['collectives'])}",
              flush=True)
    # a sweep's split, past each rank's first sweep (its warm-up)
    split: dict = {}
    for res in results:
        for ms in res["anneal"]["sweeps"][1:]:
            for k, v in (*ms.items(), ("sweep", sum(ms.values()))):
                split.setdefault(k, []).append(v)
    print("[ranks] a cross-rank sweep's event ms by entry point and "
          "collective, median [min, max] over the ranks' sweeps 1-"
          f"{RANKS_SWEEPS - 1}: " + ", ".join(
              f"{k} {statistics.median(v):.3f} [{min(v):.3f}, {max(v):.3f}]"
              for k, v in split.items()), flush=True)
    # (2)
    for res in results:
        for row, base in zip(res["sharded"], results[0]["sharded"]):
            if not np.array_equal(row["assignment"], base["assignment"]):
                raise AssertionError(f"[ranks] {row['label']}: ranks 0 and "
                                     f"{res['rank']} differ")
            if row["violations"] or row["pre"] or row["moves"] or \
                    row["on_dead"] or row["device"] != str(dev):
                raise AssertionError(f"[ranks] {row['label']} on rank "
                                     f"{res['rank']}: {row}")
            if row["label"] != "cold" and row["h2d"]:
                raise AssertionError(f"[ranks] {row['label']}: "
                                     f"{row['h2d']} uploads in the warm "
                                     f"dispatch")
        mem = res["memory"]
        print(f"[ranks] sharded rank {res['rank']}: max_memory_allocated "
              f"{mem['max_allocated']} B, per_device_bytes of its shard "
              f"{mem['per_device_bytes']} B", flush=True)
    fleet_now = None
    for row in results[0]["sharded"]:
        print(f"[ranks] sharded {row['label']}: sweeps {row['sweeps']}, "
              f"swaps {row['tempering']['swap_accepts']}/"
              f"{row['tempering']['swap_attempts']}, 0 violations, "
              f"checksum {int(np.asarray(row['assignment'], np.int64).sum())}"
              f" on every rank; timings_ms "
              f"{json.dumps({k: round(v, 3) for k, v in row['timings'].items()})}",
              flush=True)
        fleet_now = row
    prof = results[0]["profiled"]
    # gloo carries a CUDA tensor through pinned host buffers: its copy
    # back is a pinned-to-device copy; the resident state's uploads (numpy
    # to the card) are pageable ones
    other = [c for c in prof["h2d"] if "Pinned -> Device" not in c[1]]
    if prof["seen"] is None or prof["ranges"] != 1 or prof["ops"] == 0:
        raise AssertionError(f"[ranks] the traced warm burst saw no probe "
                             f"or no dispatch: {prof}")
    if other:
        raise AssertionError(f"[ranks] host-to-device copies in "
                             f"{sharded.SHARDED_RANGE} outside the "
                             f"collectives: {other}")
    print(f"[ranks] warm {sharded.SHARDED_RANGE} under torch.profiler on "
          f"rank 0: {prof['ops']} device operations linked to it, 0 "
          f"host-to-device copies but gloo's pinned staging of the "
          f"collectives ({len(prof['h2d'])} linked: "
          f"{sorted(set(prof['h2d']))}), 0 counted uploads of the resident "
          f"state; probe {prof['seen']}; last solve {fleet_now['label']}",
          flush=True)
    # (3)
    for res in results:
        got = res["chain"]
        if not (np.array_equal(got["assignment"], want_chain.assignment)
                and got["stats"] == want_chain.stats
                and got["soft"] == want_chain.soft
                and got["steps"] == want_chain.steps
                and got["accepted"] == want_chain.accepted_moves):
            raise AssertionError(f"[ranks] rank {res['rank']}: solve(mesh=) "
                                 f"differs from the one-card solve")
        for p, q in zip(res["sched"], want_sched):
            if not (np.array_equal(p["raw"], q.raw) and p["soft"] == q.soft
                    and p["feasible"] and p["violations"] == 0
                    and p["source"] == "gpu-anneal"):
                raise AssertionError(f"[ranks] rank {res['rank']}: the mesh "
                                     f"scheduler differs from the one-card "
                                     f"scheduler")
    print(f"[ranks] chain mesh {RANKS_N} ranks at "
          f"{pt_headline.S}x{pt_headline.N}: solve(chains={RANKS_CHAINS}) "
          f"bit-equal to the one-card solve ({want_chain.steps} sweeps, "
          f"{want_chain.stats['total']} violations, soft "
          f"{want_chain.soft!r}); GpuSolverScheduler(mesh=) cold and one "
          f"node down equal to the one-card scheduler's", flush=True)
    for res in results:
        print(f"[ranks] rank {res['rank']}: started in {res['init_s']:.1f} "
              f"s (build {res['build_s']:.1f} s), steps wall ms "
              f"{json.dumps({k: round(v, 3) for k, v in res['steps_ms'].items()})}",
              flush=True)
    recs.update(check_rank_entries(torch, (sharded, sr, anneal), anneal_case,
                                   dev))
    print(f"[ranks] NCCL not exercised: this host has one card and NCCL "
          f"takes one rank a card; the {RANKS_N} ranks ran over gloo on it",
          flush=True)
    took = time.perf_counter() - t_phase
    print(f"[ranks] phase {took:.1f} s (the workers {t_workers:.1f} s) of "
          f"its {RANKS_BUDGET_S:.0f} s budget"
          + (" -- OVER BUDGET" if took > RANKS_BUDGET_S else "")
          + f"; {card}", flush=True)
    return counts


def small_agreement(torch, lower, solve):
    """A small instance solved on the card and with the plain versions on
    the CPU: both feasible, soft scores close."""
    pt = lower.synthetic_problem(400, 48, seed=3, n_tenants=3)
    gpu = solve(pt, seed=3)
    cpu = solve(pt, device="cpu", seed=3, chains=2, proposals_per_step=200)
    if not (gpu.feasible and cpu.feasible):
        raise AssertionError(f"small instance infeasible: gpu {gpu.stats}, "
                             f"cpu {cpu.stats}")
    if abs(gpu.soft - cpu.soft) > 0.15 * abs(cpu.soft):
        raise AssertionError(f"small soft {gpu.soft} vs cpu {cpu.soft}")
    print(f"[small] 400x48 feasible on both; soft gpu {gpu.soft:.6f} "
          f"cpu {cpu.soft:.6f}", flush=True)


# [frontend]: the fleet the reference bench's pipeline generates for one
# tenant (fleetgen), the shape its lowering gives, and the examples
FRONTEND_FLEET = dict(fleet="t0", n_services=10_000, seed=100,
                      n_nodes_hint=1_000, port_base=10_000)
FRONTEND_SERVERS = dict(n=1_000, seed=7)
FRONTEND_SHAPE = (10_602, 1_000)
EXAMPLES = ("hello-world", "production", "plan-simulate")
FRONTEND_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "frontend")


def flows_equal(serialize, a, b) -> bool:
    return serialize.flow_to_dict(a) == serialize.flow_to_dict(b)


def tensors_equal(np, a, b) -> list:
    """The fields in which two ProblemTensors differ (exact, dtype too)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y))
        else:
            same = x == y
        if not same:
            bad.append(f.name)
    return bad


def timed_parse(core, text: str, native: bool):
    """(flow, ms) of one uncached parse_kdl_string, the native fast path
    on or off (FLEET_KDL_NATIVE)."""
    with env_set(FLEET_KDL_NATIVE=None if native else "0"):
        t0 = time.perf_counter()
        flow = core.parse_kdl_string(text, cache=False)
        return flow, (time.perf_counter() - t0) * 1e3


def example_projects(root: str) -> list:
    """(name, project root) of each example: plan-simulate ships its flow
    as one file, so it is copied into a project of its own under `root`."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for name in EXAMPLES:
        src = os.path.join(here, "examples", name)
        if not os.path.isdir(os.path.join(src, ".fleetflow")):
            proj = os.path.join(root, name, ".fleetflow")
            os.makedirs(proj, exist_ok=True)
            with open(os.path.join(src, "flow.kdl")) as f_in, \
                    open(os.path.join(proj, "fleet.kdl"), "w") as f_out:
                f_out.write(f_in.read())
            src = os.path.join(root, name)
        out.append((name, src))
    return out


def run_frontend_phase(torch, np, mods, dev_name, fleet=FRONTEND_FLEET,
                       servers=FRONTEND_SERVERS, shape=FRONTEND_SHAPE,
                       root=FRONTEND_DIR):
    """[frontend]: KDL text to the card. (a) The generated fleet and its
    server pool parsed through the native fast path and through the Python
    parser (equal Flows), lowered by lower_stage to `shape`, then a
    GpuSolverScheduler() cold place and reschedules after one node and 5%
    of the nodes down; explain_assignment of a port row and a colocated
    row. The same fleet loaded as a two-file project with
    FLEET_PARSE_WORKERS=2 (a fork pool, after CUDA is up) lowers to the
    same tensors. (b) Every stage of the examples, loaded with the same
    pool, lowered and placed through place_with_fallback (production's
    stage declares a fallback and needs it). Returns the launch counts of
    the phase, and the parsed fleet and server pool [cp] reuses."""
    (_ext, GpuSolverScheduler, ProblemDelta, verify, solve,
     place_with_fallback, relax_problem, core, serialize, fleetgen, lower,
     native_kdl, parsecache, explain_assignment) = mods
    fleet_text = fleetgen.generate_fleet_kdl(
        fleet["fleet"], fleet["n_services"], seed=fleet["seed"],
        n_nodes_hint=fleet["n_nodes_hint"], port_base=fleet["port_base"])
    servers_text = fleetgen.generate_servers_kdl(servers["n"],
                                                 seed=servers["seed"])
    parse_ms = {}
    parsed = {}
    for native in (True, False):
        path = "native" if native else "python"
        flow, ms_f = timed_parse(core, fleet_text, native)
        pool, ms_s = timed_parse(core, servers_text, native)
        parsed[path] = (flow, pool)
        parse_ms[path] = ms_f + ms_s
    if not (flows_equal(serialize, parsed["native"][0], parsed["python"][0])
            and flows_equal(serialize, parsed["native"][1],
                            parsed["python"][1])):
        raise AssertionError("[frontend] the native and Python parses "
                             "differ")
    flow, pool = parsed["native"]
    nodes = list(pool.servers.values())
    t0 = time.perf_counter()
    pt = lower.lower_stage(flow, "prod", nodes=nodes)
    lower_ms = (time.perf_counter() - t0) * 1e3
    if shape is not None and (pt.S, pt.N) != shape:
        raise AssertionError(f"[frontend] lowered {pt.S}x{pt.N}, expected "
                             f"{shape[0]}x{shape[1]}")
    print(f"[frontend] {json.dumps(dict(kdl_bytes=len(fleet_text) + len(servers_text), assembly=native_kdl.assembly(), native_parse_ms=round(parse_ms['native'], 3), python_parse_ms=round(parse_ms['python'], 3), lower_ms=round(lower_ms, 3), rows=pt.S, nodes=pt.N, port_rows=int((pt.port_ids >= 0).any(1).sum()), max_depth=int(pt.dep_depth.max())))}",
          flush=True)

    sched = GpuSolverScheduler()
    torch.cuda.synchronize()
    _ext.reset_launches()
    record = make_record(sched, verify, _ext, dev_name, "frontend")
    gauge = parsecache.M_FRONTEND_PHASE_MS
    t0 = time.perf_counter()
    placed = sched.place(pt)
    record("cold", placed, pt, wall_ms=round((time.perf_counter() - t0)
                                             * 1e3, 3))
    cold = placed.raw.copy()
    rng = np.random.default_rng(0)
    valid = pt.node_valid.copy()
    valid[int(np.bincount(cold, minlength=pt.N).argmax())] = False
    pt_now = pt
    for label in ("warm_one_node_down", "warm_5pct_nodes_down"):
        if label == "warm_5pct_nodes_down":
            alive = np.flatnonzero(valid)
            valid[rng.choice(alive, int(0.05 * pt.N), replace=False)] = False
        pt_now = dataclasses.replace(pt, node_valid=valid.copy())
        t0 = time.perf_counter()
        placed = sched.reschedule(pt_now, delta=ProblemDelta(
            node_valid=valid.copy()))
        record(label, placed, pt_now,
               wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
    # a bucketed solve() stages cold itself and sets the front end's stage
    # gauge
    t0 = time.perf_counter()
    res = solve(pt, seed=0, bucket=True)
    wall = (time.perf_counter() - t0) * 1e3
    check_solve(res, pt, verify, dev_name, "[frontend] solve()")
    print(f"[frontend] {json.dumps(dict(solve='solve()', wall_ms=round(wall, 3), stage_ms=round(gauge.value(phase='stage'), 3), sweeps=res.steps))}",
          flush=True)
    since = tally_size(_ext, pt.S, pt.N)
    print(f"[frontend] fleet launches {json.dumps(since)}", flush=True)
    missing = [k for k in ("k4_greedy", "k3_rebuild", "k1_sweep")
               if since[k] == 0]
    if missing:
        raise AssertionError(f"[frontend] {missing} did not launch")

    rows = {"port": np.flatnonzero((pt.port_ids >= 0).any(1)),
            "coloc": np.flatnonzero((pt.coloc_ids >= 0).any(1))}
    for kind, idx in rows.items():
        if idx.size == 0:
            raise AssertionError(f"[frontend] no {kind} row to explain")
        name = pt.service_names[int(idx[0])]
        rep = explain_assignment(pt, cold, name)
        if not rep["chosen"]["feasible"]:
            raise AssertionError(f"[frontend] explain {name}: {rep}")
        print(f"[frontend] explain {json.dumps(dict(kind=kind, service=name, chosen=rep['chosen']['node'], rank=rep['chosen_rank'], feasible_nodes=rep['blocked_counts']['feasible']))}",
              flush=True)

    # the same fleet as a project of two files, parsed by a fork pool of 2
    # workers after CUDA is up (the workers only parse)
    proj = os.path.join(root, "fleet", ".fleetflow")
    os.makedirs(proj, exist_ok=True)
    for fname, text in (("cloud.kdl", servers_text),
                        ("fleet.kdl", fleet_text)):
        with open(os.path.join(proj, fname), "w") as f:
            f.write(text)
    with env_set(FLEET_PARSE_WORKERS="2"):
        t0 = time.perf_counter()
        loaded = core.load_project_from_root_with_stage(
            os.path.dirname(proj), "prod")
        load_ms = (time.perf_counter() - t0) * 1e3
    got = lower.lower_stage(loaded, "prod")
    bad = tensors_equal(np, pt, got)
    if bad:
        raise AssertionError(f"[frontend] the loaded project lowers "
                             f"otherwise: {bad}")
    print(f"[frontend] {json.dumps(dict(project='fleet', workers=2, load_ms=round(load_ms, 3), parse_ms=round(gauge.value(phase='parse'), 3)))}",
          flush=True)

    # (b) the examples, every stage, through the same pool
    n_stages = 0
    with env_set(FLEET_PARSE_WORKERS="2"):
        for name, path in example_projects(root):
            with open(os.path.join(path, ".fleetflow", "fleet.kdl")) as f:
                stages = [n.args[0] for n in core.parse_document(f.read())
                          if n.name == "stage"]
            for st in stages:
                ex_flow = core.load_project_from_root_with_stage(path, st)
                ex_pt = lower.lower_stage(ex_flow, st)
                # a stage that declares fallback{} is placed as its users
                # place it: relaxing its classes in order while infeasible
                t0 = time.perf_counter()
                placed, relaxed = place_with_fallback(
                    sched, ex_pt, place_kwargs={"stage": f"{name}/{st}"})
                wall = (time.perf_counter() - t0) * 1e3
                final_pt = ex_pt
                for what in relaxed:
                    final_pt = relax_problem(final_pt, what)
                record(f"{name}/{st}", placed, final_pt, rows=ex_pt.S,
                       nodes=ex_pt.N, relaxed=relaxed, wall_ms=round(wall, 3))
                since = tally_size(_ext, ex_pt.S, ex_pt.N, since)
                if name == "production":
                    pol = ex_flow.stages[st].placement
                    if not (pol and pol.resource_quota
                            and pol.fallback_policy
                            and ex_pt.relax_order and ex_pt.max_skew > 0):
                        raise AssertionError(f"[frontend] {name}/{st} lost "
                                             f"its policy")
                n_stages += 1
    if n_stages < len(EXAMPLES):
        raise AssertionError(f"[frontend] {n_stages} example stages")
    return read_launches(torch, _ext, "frontend",
                         ("k1_sweep", "k3_rebuild", "k4_greedy"),
                         off=("k6_greedy_scan",)), flow, pool


# [cp]: the second stage on the same servers, the admission stream and the
# second burst's size
CP_SECOND_FLEET = dict(fleet="t1", n_services=1_000, seed=101,
                       n_nodes_hint=1_000, port_base=30_000)
CP_ARRIVALS = 64
CP_DEPARTURES = 16
CP_KILL = 50
CP_COLD = ("k4_greedy", "k3_rebuild", "k1_sweep")
CP_WARM = ("k2_prerepair", "k5_subsolve")


def cp_store(cp_models, Store, pool):
    """A control-plane store holding the server pool's KDL servers as
    online Server records, with their capacities and labels."""
    store = Store.connect_memory()
    with store.batch():
        for srv in pool.servers.values():
            cap, lbl = srv.capacity, srv.labels
            store.create("servers", cp_models.Server(
                slug=srv.name, hostname=srv.name, status="online",
                tenant="default",
                capacity=cp_models.ServerCapacity(
                    cpu=cap.cpu, memory=cap.memory, disk=cap.disk),
                labels=cp_models.ServerLabelsRec(
                    tier=lbl.tier, region=lbl.region, clazz=lbl.clazz,
                    arch=lbl.arch, extra=dict(lbl.extra))))
    return store


def busiest_shared(svc, key0: str, key1: str) -> str:
    """The node holding the most of stage `key0`'s rows among the nodes
    that hold rows of both stages (ties: the first by name)."""
    a1 = set(svc.retained(key1)[1].assignment.values())
    counts: dict = {}
    for node in svc.retained(key0)[1].assignment.values():
        if node in a1:
            counts[node] = counts.get(node, 0) + 1
    return max(sorted(counts), key=counts.get)


def cp_expect_launches(label: str, launched: dict, want: tuple,
                       any_of: bool = False, tag: str = "cp") -> None:
    """A [cp] call launched every kernel of `want` (or one, `any_of`)."""
    hit = [k for k in want if launched.get(k, 0) > 0]
    if (not hit) if any_of else len(hit) < len(want):
        raise AssertionError(f"[{tag}] {label}: launches {launched}, "
                             f"expected {'one' if any_of else 'all'} of "
                             f"{want}")


class CpMeter:
    """Times a PlacementService's calls and splits their wall time: the
    card scheduler's solves (each one's SolveResult kept, its launches
    tallied at its fleet size), and on the host the lowering, the
    inventory and the rest (the reservation book and the store)."""

    def __init__(self, _ext, cp_placement, svc):
        self._ext, self.mod, self.svc = _ext, cp_placement, svc
        self.sched = svc._sched_gpu
        self.ms = {"lower": 0.0, "inventory": 0.0, "solve": 0.0}
        self.results: list = []
        self.per_solve: list = []    # each solve's launches, by kernel
        self.since = None
        self._lower = cp_placement.lower_stage
        place, inventory = self.sched.place, svc._inventory

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.ms[key] += (time.perf_counter() - t0) * 1e3
            return run

        def solve(pt, **kw):
            before = dict(_ext.LAUNCHES)
            out = timed("solve", place)(pt, **kw)
            self.results.append(self.sched.last_result)
            self.since = tally_size(_ext, pt.S, pt.N, self.since)
            self.per_solve.append({k: v - before[k]
                                   for k, v in self.since.items()
                                   if v != before[k]})
            return out

        cp_placement.lower_stage = timed("lower", self._lower)
        svc._inventory = timed("inventory", inventory)
        self.sched.place = solve

    def close(self) -> None:
        self.mod.lower_stage = self._lower

    def call(self, label: str, fn, card: str, **extra):
        """Run fn() as one metered call; print and return its row."""
        out, row = self.measure(label, fn, card, **extra)
        print(f"[cp] {json.dumps(row)}", flush=True)
        return out, row

    def measure(self, label: str, fn, card: str, **extra):
        """Run fn() as one metered call; return its output and row."""
        self.ms = dict.fromkeys(self.ms, 0.0)
        self.results = []
        self.per_solve = []
        seen = dict(self._ext.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: v - seen[k] for k, v in self._ext.LAUNCHES.items()
                    if v != seen[k]}
        host = wall - self.ms["solve"]
        row = dict(call=label, wall_ms=round(wall, 3),
                   solves=len(self.results),
                   solve_ms=round(self.ms["solve"], 3),
                   sweeps=[r.steps for r in self.results],
                   subsolve=[(r.subsolve or {}).get("outcome")
                             for r in self.results],
                   timings_ms=[{k: round(v, 3)
                                for k, v in r.timings_ms.items()}
                               for r in self.results],
                   host_ms=round(host, 3),
                   lower_ms=round(self.ms["lower"], 3),
                   inventory_ms=round(self.ms["inventory"], 3),
                   bookkeeping_ms=round(host - self.ms["lower"]
                                        - self.ms["inventory"], 3),
                   launches=launched, **extra, card=card)
        return out, row


def cp_check(np, svc, verify, dev_name: str, dead: set, meter, label: str,
             card: str, tag: str = "cp"):
    """Every retained placement: feasible, 0 violations by the host
    verify, nothing on a dead node, the card's source; each of the call's
    solves on the card; the servers' committed and reserved demand, and
    the retained placements' summed load, within every capacity."""
    for res in meter.results:
        if res.device != dev_name:
            raise AssertionError(f"[{tag}] {label}: solved on {res.device}")
    load: dict = {}
    for key in svc.snapshot():
        pt, pl = svc.retained(key)
        raw = np.asarray(pl.raw)
        host = verify(pt, raw)
        on_dead = sorted(set(pl.assignment.values()) & dead)
        if (not pl.feasible or pl.violations or host["total"]
                or (~pt.node_valid[raw]).any() or on_dead):
            raise AssertionError(
                f"[{tag}] {label}: {key} feasible={pl.feasible} violations "
                f"{pl.violations} host {host} on dead nodes {on_dead[:5]}")
        if not pl.source.startswith("gpu-anneal"):
            raise AssertionError(f"[{tag}] {label}: {key} source {pl.source}")
        for i, j in enumerate(raw):
            slug = pt.node_names[int(j)]
            load[slug] = load.get(slug, 0.0) + pt.demand[i].astype(
                np.float64)
    booked = {}
    for s in svc.store.list("servers"):
        booked[s.slug] = np.array([s.allocated.cpu, s.allocated.memory,
                                   s.allocated.disk])
    for r in svc.reservations_snapshot()["in_flight"]:
        for slug, d in r["demand_by_node"].items():
            booked[slug] = booked[slug] + np.asarray(d)
    fill = 0.0
    for s in svc.store.list("servers"):
        cap = np.array([s.capacity.cpu, s.capacity.memory, s.capacity.disk])
        for what, v in (("retained load", load.get(s.slug, 0.0)),
                        ("booked", booked[s.slug])):
            if (np.asarray(v) > cap * (1 + 1e-6) + 1e-3).any():
                raise AssertionError(f"[{tag}] {label}: {s.slug} {what} {v} "
                                     f"over capacity {cap}")
        fill = max(fill, float((booked[s.slug] / cap).max()))
    snap = svc.reservations_snapshot()
    print(f"[{tag}] book {json.dumps(dict(after=label, max_fill=round(fill, 6), in_flight=len(snap['in_flight']), committed=len(snap['committed']), card=card))}",
          flush=True)


def run_cp_phase(torch, np, mods, dev_name, flow, pool, card, device=None,
                 second=CP_SECOND_FLEET, arrivals=CP_ARRIVALS,
                 departures=CP_DEPARTURES, kill=CP_KILL):
    """[cp]: the control plane's placement path on the card. A Store of
    [frontend]'s server pool; ``PlacementService(store)`` (the card by
    default: `device` names another only for a rehearsal) solves and
    commits [frontend]'s fleet and a second stage on the same servers,
    re-solves both after one node and then `kill` nodes go down and
    commits what the churn placed; an AdmissionController on the first
    stage drains `arrivals` arrivals and `departures` departures through
    step(); explain of a port row. Each call prints its wall, solve and
    host ms and the solver's timings; every check of cp_check holds after
    each, the churn-fallback counter never moves, the cold solves launch
    K4, K3 and K1 and the warm ones K2 or K5, and every admission
    micro-solve is a resident delta merge. Returns the phase's launch
    counts."""
    (_ext, cp_models, Store, cp_placement, AdmissionController,
     AdmissionConfig, REGISTRY, verify, fleetgen, core) = mods
    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    reuse = REGISTRY.get("fleet_solver_resident_reuse_total")
    fallbacks0 = fallbacks.value()
    store = cp_store(cp_models, Store, pool)
    svc = cp_placement.PlacementService(store, device=device)
    t1_text = fleetgen.generate_fleet_kdl(
        second["fleet"], second["n_services"], seed=second["seed"],
        n_nodes_hint=second["n_nodes_hint"], port_base=second["port_base"])
    flow2 = core.parse_kdl_string(t1_text, cache=False)
    torch.cuda.synchronize()
    _ext.reset_launches()
    meter = CpMeter(_ext, cp_placement, svc)
    dead: set = set()
    try:
        for fl in (flow, flow2):
            key = f"{fl.name}/prod"
            (pl, rid), row = meter.call(
                f"solve_stage {key}",
                lambda fl=fl: svc.solve_stage(fl, "prod"), card)
            cp_expect_launches(row["call"], row["launches"], CP_COLD)
            t0 = time.perf_counter()
            if not svc.commit(rid):
                raise AssertionError(f"[cp] commit {key} refused")
            print(f"[cp] {json.dumps(dict(call=f'commit {key}', wall_ms=round((time.perf_counter() - t0) * 1e3, 3), card=card))}",
                  flush=True)
            cp_check(np, svc, verify, dev_name, dead, meter, row["call"],
                     card)

        # the busiest node of the first stage that holds both stages'
        # services, then `kill` more of the live nodes
        victim = busiest_shared(svc, f"{flow.name}/prod",
                                f"{flow2.name}/prod")
        rng = np.random.default_rng(0)
        alive = sorted(s.slug for s in store.list("servers")
                       if s.slug != victim)
        burst = [str(x) for x in rng.choice(alive, kill, replace=False)]
        for label, slugs in (("node_events one node", [victim]),
                             (f"node_events {kill} nodes", burst)):
            dead |= set(slugs)
            moved, row = meter.call(
                label, lambda slugs=slugs: svc.node_events(
                    [(s, False) for s in slugs]), card, events=len(slugs))
            if len(moved) != 2:
                raise AssertionError(f"[cp] {label} re-solved "
                                     f"{[k for k, _ in moved]}")
            cp_expect_launches(label, row["launches"], CP_WARM, any_of=True)
            cp_check(np, svc, verify, dev_name, dead, meter, label, card)
        for fl in (flow, flow2):
            if not svc.commit_retained(f"{fl.name}/prod"):
                raise AssertionError(f"[cp] commit_retained {fl.name}")
        cp_check(np, svc, verify, dev_name, dead, meter,
                 "commit_retained", card)

        ctrl = AdmissionController(svc, config=AdmissionConfig(
            batch_max=max(arrivals, departures)))
        key = ctrl.attach(flow, "prod")
        cold0, delta0 = reuse.value(outcome="cold"), \
            reuse.value(outcome="delta")
        names = [f"cp-arrival-{i:03d}" for i in range(arrivals)]
        ctrl.submit("t0", arrivals=[
            {"name": n, "cpu": 0.25, "memory": 256.0, "disk": 512.0}
            for n in names])
        out, row = meter.call(f"admit {arrivals} arrivals", ctrl.step, card)
        if sorted(out["placed"]) != names:
            raise AssertionError(f"[cp] admitted {out}")
        cp_expect_launches(row["call"], row["launches"], CP_WARM,
                           any_of=True)
        cp_check(np, svc, verify, dev_name, dead, meter, row["call"],
                     card)
        ctrl.submit("t0", departures=names[:departures])
        out, row = meter.call(f"admit {departures} departures", ctrl.step,
                              card)
        if sorted(out["departed"]) != names[:departures]:
            raise AssertionError(f"[cp] departed {out}")
        cp_check(np, svc, verify, dev_name, dead, meter, row["call"],
                     card)
        live = ctrl.live_names(key)
        st = ctrl.status()
        solves = st["stats"]["solves"]
        cold = reuse.value(outcome="cold") - cold0
        delta = reuse.value(outcome="delta") - delta0
        print(f"[cp] admission {json.dumps(dict(stage=key, solves=solves, admitted=st['stats']['admitted'], departed=st['stats']['departed'], parked=st['parked'], live=len(live), resident_delta=delta, resident_cold=cold, streams=st['streams'][key], phase_ms=st['solve_phases_ms'], card=card))}",
              flush=True)
        if cold or delta != solves or len(live) != arrivals - departures:
            raise AssertionError(f"[cp] admission: {solves} micro-solves, "
                                 f"{delta} delta merges, {cold} cold "
                                 f"restages, {len(live)} live")

        pt, _pl = svc.retained(key)
        row_i = int(np.flatnonzero((pt.port_ids >= 0).any(1))[0])
        rep = svc.explain(key, pt.service_names[row_i])
        if not rep["chosen"]["feasible"] or rep["source"] != "gpu-anneal":
            raise AssertionError(f"[cp] explain: {rep}")
        print(f"[cp] explain {json.dumps(dict(stage=key, service=pt.service_names[row_i], chosen=rep['chosen']['node'], rank=rep['chosen_rank'], feasible_nodes=rep['blocked_counts']['feasible']))}",
              flush=True)
    finally:
        meter.close()
    moved = fallbacks.value() - fallbacks0
    print(f"[cp] {json.dumps(dict(fallbacks=moved, sources=sorted({v['source'] for v in svc.snapshot().values()}), slots=[s['stage'] for s in svc.solver_slots()['slots']], card=card))}",
          flush=True)
    if moved:
        raise AssertionError(f"[cp] {moved} churn fallbacks")
    return read_launches(torch, _ext, "cp", CP_COLD,
                         off=("k6_greedy_scan",))


HEAL_BURST2 = 8            # burst 2: seeded live nodes that lapse together
HEAL_TICK_S = 10.0         # the agents' heartbeat interval (virtual s)
HEAL_MAX_TICKS = 64        # burst 2 needs lease + grace = 12 ticks
HEAL_BUDGET_S = 150.0      # the phase's time on the card's host
HEAL_SHARDS = 4            # the registry's shard table: send_batch lanes


def heal_kit(root: str = "fleetflow_tpu_torch") -> SimpleNamespace:
    """The classes and functions the heal drive uses, from package `root`
    (the port; its parity tests pass the reference's name as well)."""
    def mod(name: str):
        return importlib.import_module(f"{root}.{name}")
    rt, base, lower = mod("runtime"), mod("sched.base"), mod("lower.tensors")
    fd, models = mod("cp.failure_detector"), mod("cp.models")
    rc = mod("cp.reconverge")
    return SimpleNamespace(
        root=root, DeployEngine=rt.DeployEngine,
        DeployRequest=rt.DeployRequest, MockBackend=rt.MockBackend,
        container_name=rt.container_name, Placement=base.Placement,
        level_schedule=base.level_schedule, lower_stage=lower.lower_stage,
        local_node=lower.local_node,
        flow_from_dict=mod("core.serialize").flow_from_dict,
        ControlPlaneError=mod("core.errors").ControlPlaneError,
        AgentRegistry=mod("cp.agent_registry").AgentRegistry,
        ShardTable=mod("cp.shards").ShardTable,
        FailureDetector=fd.FailureDetector, LeaseConfig=fd.LeaseConfig,
        Reconverger=rc.Reconverger, reconverge=rc,
        Deployment=models.Deployment,
        DeploymentStatus=models.DeploymentStatus)


class SimConnection:
    """Duck-types the protocol's Connection for the agent registry: the
    wire is an inline call into the agent (the reference's chaos world's
    SimConnection)."""

    def __init__(self, agent: "SimAgent"):
        self.agent = agent
        self.identity = agent.slug
        self._closed = False

    async def send_event(self, channel: str, method: str,
                         payload: dict) -> None:
        if self._closed:
            raise self.agent.fleet.kit.ControlPlaneError(
                f"connection to {self.agent.slug} is closed")
        await self.agent.on_command(method, payload)

    async def close(self) -> None:
        self._closed = True


class SimAgent:
    """One node: a ``MockBackend(auto_pull=True)`` and the agent's
    ``deploy.execute``, answered through the registry's
    ``resolve_result``. Its idempotency cache keeps the newest key of each
    stage (project and stage name): a fresh key is a fresh assignment and
    supersedes the last, so a replay of the current one answers from the
    cache and the cache holds at most one entry a stage."""

    def __init__(self, slug: str, fleet: "HealAgents"):
        self.slug, self.fleet = slug, fleet
        self.backend = fleet.kit.MockBackend(auto_pull=True)
        self.conn = SimConnection(self)
        self.idem: dict = {}

    async def on_command(self, method: str, payload: dict) -> None:
        request_id = payload.get("request_id")
        try:
            reply = {"request_id": request_id, "result": self.execute(
                method, payload.get("payload", {}))}
        except Exception as e:   # errors ride back, as an agent's do
            reply = {"request_id": request_id, "error": str(e)}
        if request_id:
            self.fleet.registry.resolve_result(request_id, reply)

    def execute(self, method: str, payload: dict) -> dict:
        if method != "deploy.execute":
            raise ValueError(f"unknown command {method!r}")
        d, key = payload["request"], payload.get("idempotency_key")
        stage = (d["flow"]["name"], d["stage_name"])
        hit = self.idem.get(stage)
        if key and hit is not None and hit[0] == key:
            self.fleet.replays += 1
            return hit[1]
        req = self.fleet.request(key, d)
        req.node = req.node or self.slug
        result = self.fleet.run(self, req, payload.get("assignment"))
        if key:
            self.idem[stage] = (key, result)
        return result


class HealAgents:
    """The in-process agents of a heal drive, one a server. They decode a
    request's flow once per stage and idempotency key and share it, and
    build a stage's level schedule once (the chaos world's cache): a real
    agent decodes on its own host, and 1,000 decodes of a 10k-service
    flow in one process would take ~85 s. The decodes, the level
    schedules and the engines' runs are timed apart."""

    def __init__(self, kit, slugs, registry, clock):
        self.kit, self.registry, self.clock = kit, registry, clock
        self.agents = {s: SimAgent(s, self) for s in slugs}
        self._flows: dict = {}     # (project, stage) -> (key, Flow)
        self._levels: dict = {}    # (stage, its services) -> level schedule
        self.ms = dict(decode=0.0, levels=0.0, engine=0.0)
        self.executions = 0
        self.replays = 0

    def take(self) -> dict:
        """The timings and counts since the last take, zeroed."""
        out = dict({k: round(v, 3) for k, v in self.ms.items()},
                   executions=self.executions, replays=self.replays)
        self.ms = dict.fromkeys(self.ms, 0.0)
        self.executions = self.replays = 0
        return out

    def connect(self, slug: str) -> None:
        self.registry.register(slug, self.agents[slug].conn, principal=slug)

    def disconnect(self, slug: str) -> None:
        conn = self.agents[slug].conn
        conn._closed = True
        self.registry.unregister(slug, conn)

    def request(self, key: Optional[str], d: dict):
        """The DeployRequest of wire dict `d`; its flow is decoded once per
        stage and idempotency key."""
        stage = (d["flow"]["name"], d["stage_name"])
        have = self._flows.get(stage)
        if have is None or key is None or have[0] != key:
            t0 = time.perf_counter()
            flow = self.kit.flow_from_dict(d["flow"])
            self.ms["decode"] += (time.perf_counter() - t0) * 1e3
            have = self._flows[stage] = (key, flow)
        return self.kit.DeployRequest(
            flow=have[1], stage_name=d["stage_name"],
            target_services=d.get("target_services", []),
            no_pull=d.get("no_pull", False),
            no_prune=d.get("no_prune", False), node=d.get("node"),
            trace_id=d.get("trace_id"))

    def placement(self, req, assignment: dict):
        """The control plane's placement as an agent executes it: the
        assignment with the stage's level schedule (the chaos world's
        cp_placement, keyed on the stage's service list)."""
        sig = (req.flow.name, req.stage_name,
               tuple(req.flow.stage(req.stage_name).services))
        levels = self._levels.get(sig)
        if levels is None:
            t0 = time.perf_counter()
            pt = self.kit.lower_stage(
                req.flow, req.stage_name,
                nodes=[self.kit.local_node(req.node or "sim")])
            levels = self.kit.level_schedule(pt)
            if len(self._levels) > 8:
                self._levels.clear()
            self._levels[sig] = levels
            self.ms["levels"] += (time.perf_counter() - t0) * 1e3
        return self.kit.Placement(assignment=assignment, levels=levels,
                                  feasible=True, source="cp-solved")

    def run(self, agent: SimAgent, req, assignment: dict) -> dict:
        """Execute `req` on `agent` with the control plane's assignment."""
        placement = self.placement(req, assignment)
        t0 = time.perf_counter()
        engine = self.kit.DeployEngine(agent.backend,
                                       sleep=self.clock.advance)
        res = engine.execute(req, placement=placement)
        self.ms["engine"] += (time.perf_counter() - t0) * 1e3
        self.executions += 1
        if not res.ok:
            raise RuntimeError(f"failed services: {sorted(res.failed)}")
        return {"deployed": res.deployed, "removed": res.removed}

    def cache_sizes(self) -> dict:
        return dict(idempotency=sum(len(a.idem)
                                    for a in self.agents.values()),
                    flows=len(self._flows), levels=len(self._levels))


class HealWorld:
    """A control plane's self-healing loop over in-process agents on a
    virtual clock: an AgentRegistry with a shard table, one SimAgent a
    server, a FailureDetector primed for every server and fed heartbeats,
    and the Reconverger on a plain holder of the store, the placement
    service and the registry."""

    def __init__(self, kit, store, svc, slugs, shards: int = HEAL_SHARDS):
        # the chaos world's clock: it moves only when the drive ticks it
        # or a deploy engine's wait sleeps on it
        from fleetflow_tpu_torch.chaos.runner import VirtualClock
        self.kit, self.store, self.svc = kit, store, svc
        self.clock = VirtualClock()
        self.registry = kit.AgentRegistry(shard_table=kit.ShardTable(shards))
        self.fleet = HealAgents(kit, slugs, self.registry, self.clock)
        self.detector = kit.FailureDetector(kit.LeaseConfig(),
                                            clock=self.clock.now)
        for slug in slugs:
            self.fleet.connect(slug)
            self.detector.prime(slug)
            self.detector.observe_heartbeat(slug)
        # the state the reconverger reads (its HealState): the server's
        # AppState holds these three and more
        state = SimpleNamespace(store=store, placement=svc,
                                agent_registry=self.registry)
        self.rc = kit.Reconverger(state, self.detector, clock=self.clock.now,
                                  rng=random.Random(0))
        self.silent: set = set()
        self.loop = asyncio.new_event_loop()

    def close(self) -> None:
        self.loop.run_until_complete(self.loop.shutdown_default_executor())
        self.loop.close()

    def deploy(self, flow, stage: str) -> None:
        """What a deploy of the stage leaves behind (the reference's
        handlers.execute_deploy, not ported): its Deployment record with
        the replay template, and each node's slice running on its agent's
        backend, executed there directly, with no wire."""
        assignment = self.svc.retained(f"{flow.name}/{stage}")[1].assignment
        db = self.store
        tenant = db.ensure_tenant("default")
        project = db.ensure_project(tenant.name, flow.name)
        st = db.ensure_stage(project.id, stage)
        req = self.kit.DeployRequest(flow=flow, stage_name=stage).to_dict()
        db.create("deployments", self.kit.Deployment(
            tenant=tenant.name, project=project.id, stage=st.id,
            status=self.kit.DeploymentStatus.SUCCEEDED.value,
            services=[s.name for s in flow.stage(stage).resolved_services(
                flow)],
            placement=dict(assignment), request=req))
        for slug in sorted(set(assignment.values())):
            self.fleet.run(self.fleet.agents[slug], self.kit.DeployRequest(
                flow=flow, stage_name=stage, node=slug), assignment)

    def kill(self, slugs, *, disconnect: bool) -> None:
        """The nodes stop heartbeating; with `disconnect`, their agents'
        sessions drop too."""
        for slug in slugs:
            self.silent.add(slug)
            if disconnect:
                self.fleet.disconnect(slug)
                self.detector.observe_disconnect(slug)

    def tick(self) -> None:
        """One heartbeat interval: the clock moves, every live agent
        heartbeats."""
        self.clock.advance(HEAL_TICK_S)
        for slug in self.fleet.agents:
            if slug not in self.silent:
                self.detector.observe_heartbeat(slug)

    def step(self) -> dict:
        return self.loop.run_until_complete(self.rc.step())

    def until_verdict(self, on_step=None) -> tuple[dict, int]:
        """Tick until a step's sweep hands out verdicts; returns that
        step's summary and the ticks it took. `on_step(step)` runs each
        step (a meter)."""
        for tick in range(1, HEAL_MAX_TICKS + 1):
            self.tick()
            summary = on_step(self.step) if on_step else self.step()
            if summary["dead"] or summary["online"]:
                return summary, tick
        raise AssertionError(f"no verdict in {HEAL_MAX_TICKS} ticks")

    def misplaced(self, key: str) -> list:
        """Rows of stage `key` with no running container on the backend
        of the node its retained placement names."""
        project, _, stage = key.partition("/")
        bad = []
        for row, node in self.svc.retained(key)[1].assignment.items():
            base, _, idx = row.partition("#")
            name = self.kit.container_name(project, stage, base)
            info = self.fleet.agents[node].backend.inspect(
                f"{name}-{idx}" if idx else name)
            if info is None or not info.running:
                bad.append((row, node))
        return bad

    def heal_records(self) -> dict:
        """The reconverger's Deployment records: id -> (project, stage)."""
        return {d.id: (d.project, d.stage)
                for d in self.store.list("deployments")
                if d.log.startswith("self-heal")}


@contextmanager
def heal_timers(torch, world: HealWorld, dev_name: str):
    """Time the heal's parts while inside: the detector's sweep,
    ``node_events``, the CP-side payload build (each target's
    ``DeployRequest.to_dict``), the registry's ``send_batch`` fan-out,
    ``commit_retained`` and the Deployment record; keep the ``heal_s``
    samples and, on the card, each re-solve's thread and stream."""
    t = dict(ms=dict.fromkeys(("sweep", "node_events", "payload", "fanout",
                               "commit", "record"), 0.0),
             payload_targets=0, heal_s=[], solves=[])
    svc, rc_mod = world.svc, world.kit.reconverge
    plain_req, plain_slo = rc_mod.DeployRequest, rc_mod.slo_observe

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                t["ms"][key] += (time.perf_counter() - t0) * 1e3

        async def run_async(*a, **kw):
            t0 = time.perf_counter()
            try:
                return await fn(*a, **kw)
            finally:
                t["ms"][key] += (time.perf_counter() - t0) * 1e3
        return run_async if asyncio.iscoroutinefunction(fn) else run

    class Payload(plain_req):
        def to_dict(self):
            if not self.node:    # the Deployment record's template
                return super().to_dict()
            t["payload_targets"] += 1
            return timed("payload", super().to_dict)()

    def slo(name, value):
        if name == "heal_s":
            t["heal_s"].append(value)
        return plain_slo(name, value)

    patched = [(world.detector, "sweep", "sweep"),
               (svc, "node_events", "node_events"),
               (world.registry, "send_batch", "fanout"),
               (svc, "commit_retained", "commit"),
               (world.rc, "_record_deployment", "record")]
    for obj, attr, key in patched:
        setattr(obj, attr, timed(key, getattr(obj, attr)))
    sched = getattr(svc, "_sched_gpu", None)
    if sched is not None and dev_name.startswith("cuda"):
        dev, reschedule = torch.device(dev_name), sched.reschedule

        def traced(*a, **kw):
            t["solves"].append((threading.get_ident(),
                                torch.cuda.current_stream(dev).cuda_stream))
            return reschedule(*a, **kw)
        sched.reschedule = traced
        patched.append((sched, "reschedule", None))
    rc_mod.DeployRequest, rc_mod.slo_observe = Payload, slo
    try:
        yield t
    finally:
        rc_mod.DeployRequest, rc_mod.slo_observe = plain_req, plain_slo
        for obj, attr, _ in patched:
            delattr(obj, attr)


def heal_burst(torch, np, world: HealWorld, meter, mods, dev_name: str,
               dead: set, victims: list, label: str, card: str,
               disconnect: bool, keys: list) -> dict:
    """One [heal] burst: `victims` stop (their agents' sessions drop too
    with `disconnect`), the clock ticks until the detector's sweep says
    they are dead, and that one step heals. Prints the burst's line and
    returns it; fails unless the heal held every check."""
    REGISTRY, verify = mods
    ok = REGISTRY.get("fleet_reconverge_redeliveries_total")
    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    inflight = REGISTRY.get("fleet_solver_dispatches_in_flight")
    ok0, fb0 = ok.value(outcome="ok"), fallbacks.value()
    records0 = world.heal_records()
    world.kill(victims, disconnect=disconnect)
    t_kill = world.clock.now()
    world.fleet.take()
    measured: dict = {}

    with heal_timers(torch, world, dev_name) as timers:
        def on_step(step):
            timers["ms"] = dict.fromkeys(timers["ms"], 0.0)
            timers["payload_targets"] = 0
            out, measured["row"] = meter.measure(f"heal {label}", step, card)
            return out
        summary, ticks = world.until_verdict(on_step)
    row, agents, rc = measured["row"], world.fleet.take(), world.rc
    dead |= set(victims)
    resolved = {r["stage"]: r["feasible"] for r in summary["resolved"]}
    problems = []
    if summary["dead"] != sorted(victims) or summary["online"]:
        problems.append(f"verdicts dead {summary['dead']} online "
                        f"{summary['online']}, victims {sorted(victims)}")
    if resolved != {k: True for k in keys}:
        problems.append(f"resolved {summary['resolved']}")
    if sorted(summary["redelivered"]) != sorted(keys):
        problems.append(f"redelivered {summary['redelivered']}")
    if (summary["parked"] or summary["retried"] or rc.parked_stage_keys()
            or rc.has_work()):
        problems.append(f"parked {summary['parked']} retried "
                        f"{summary['retried']} work {rc.status()['work']}")
    new = {i: v for i, v in world.heal_records().items()
           if i not in records0}
    if len(new) != len(keys) or len(set(new.values())) != len(keys):
        problems.append(f"heal records {new}")
    if ok.value(outcome="ok") - ok0 != len(keys):
        problems.append(f"ok redeliveries {ok.value(outcome='ok') - ok0}")
    if fallbacks.value() != fb0:
        problems.append(f"churn fallbacks {fallbacks.value() - fb0}")
    if inflight.value() != 0:
        problems.append(f"dispatches in flight {inflight.value()}")
    pending = {k: len(getattr(world.registry, k)) for k in
               ("_pending", "_pending_conn", "_pending_shard")}
    if any(pending.values()):
        problems.append(f"registry pending {pending}")
    caches = world.fleet.cache_sizes()
    if (caches["idempotency"] > len(world.fleet.agents) * len(keys)
            or caches["flows"] > len(keys) or caches["levels"] > len(keys)):
        problems.append(f"agents' caches {caches}")
    for key in keys:
        bad = world.misplaced(key)
        if bad:
            problems.append(f"{key}: {len(bad)} rows not running where "
                            f"placed, {bad[:3]}")
    if dev_name.startswith("cuda"):
        main = threading.get_ident()
        stream = torch.cuda.current_stream(
            torch.device(dev_name)).cuda_stream
        if len(timers["solves"]) != len(keys) or any(
                th == main or st != stream for th, st in timers["solves"]):
            problems.append(f"re-solves' threads and streams "
                            f"{timers['solves']}, main {main} {stream}")
    if len(meter.per_solve) != len(keys):
        problems.append(f"{len(meter.per_solve)} re-solves")
    if problems:
        raise AssertionError(f"[heal] {label}: " + "; ".join(problems))
    for i, launched in enumerate(meter.per_solve):
        cp_expect_launches(f"{label} re-solve {i}", launched, CP_WARM,
                           any_of=True, tag="heal")
    cp_check(np, world.svc, verify, dev_name, dead, meter, f"heal {label}",
             card)
    ms = {k: round(v, 3) for k, v in timers["ms"].items()}
    line = dict(
        burst=label, dead=summary["dead"], ticks=ticks,
        verdict_at_s=world.clock.now(), sweep_ms=ms["sweep"],
        node_events_ms=ms["node_events"], solve_ms=row["solve_ms"],
        stages=[dict(sweeps=r.steps,
                     subsolve=(r.subsolve or {}).get("outcome"),
                     timings_ms={k: round(v, 3)
                                 for k, v in r.timings_ms.items()},
                     launches=launched)
                for r, launched in zip(meter.results, meter.per_solve)],
        redeliver_ms=round(ms["payload"] + ms["fanout"], 3),
        payload_ms=ms["payload"], payload_targets=timers["payload_targets"],
        fanout_ms=ms["fanout"], agents=agents, commit_ms=ms["commit"],
        record_ms=ms["record"], step_ms=row["wall_ms"],
        heal_s=timers["heal_s"],
        since_kill_s=round(world.clock.now() - t_kill, 3),
        caches=caches, pending=pending, card=card)
    print(f"[heal] {json.dumps(line)}", flush=True)
    return line


def run_heal_phase(torch, np, mods, dev_name, flow, pool, card, device=None,
                   second=CP_SECOND_FLEET, burst2=HEAL_BURST2, kit=None):
    """[heal]: the control plane's self-healing loop on the card, at
    [cp]'s width. A fresh Store of [frontend]'s servers and
    ``PlacementService(store)`` (the card by default: `device` names
    another only for a rehearsal) solve and commit [frontend]'s fleet and
    [cp]'s second stage; each stage's Deployment record is stored as a
    deploy would, and every node's slice runs on its agent's
    MockBackend. One SimAgent a server answers the AgentRegistry; its
    DeployEngine executes the CP-solved placement on the virtual clock.
    The agents of this process decode a request's flow once per
    idempotency key and share it (a real agent decodes on its own host).
    A FailureDetector (``LeaseConfig()``) is primed for every server and
    fed heartbeats; the Reconverger runs on a plain holder of the store,
    the placement service and the registry, ``rng=Random(0)``.

    Burst 1: the busiest node both stages share stops heartbeating and
    its agent disconnects; the clock ticks until the sweep's dead verdict
    and that step heals. Burst 2: `burst2` seeded live nodes holding rows
    of both stages lapse together: one coalesced re-solve a stage. After
    each: the verdicts are the victims, both stages resolved feasible and
    redelivered, nothing parked or retried, cp_check holds, every row runs
    on its placed node's backend, a new Deployment record a stage, two
    ok redeliveries, no churn fallback, K2 or K5 in every re-solve (each
    on an executor thread, on the card's current stream), nothing pending
    in the registry, the agents' caches within one entry an agent and
    stage. Prints each burst's split. Returns the phase's launch
    counts."""
    (_ext, cp_models, Store, cp_placement, REGISTRY, verify, fleetgen,
     core) = mods
    kit = kit or heal_kit()
    t_phase = time.perf_counter()
    store = cp_store(cp_models, Store, pool)
    svc = cp_placement.PlacementService(store, device=device)
    flow2 = core.parse_kdl_string(fleetgen.generate_fleet_kdl(
        second["fleet"], second["n_services"], seed=second["seed"],
        n_nodes_hint=second["n_nodes_hint"], port_base=second["port_base"]),
        cache=False)
    flows = (flow, flow2)
    keys = [f"{fl.name}/prod" for fl in flows]
    slugs = sorted(s.slug for s in store.list("servers"))
    torch.cuda.synchronize()
    _ext.reset_launches()
    meter = CpMeter(_ext, cp_placement, svc)
    world = None
    try:
        for fl, key in zip(flows, keys):
            (pl, rid), row = meter.measure(
                f"solve_stage {key}",
                lambda fl=fl: svc.solve_stage(fl, "prod"), card)
            print(f"[heal] {json.dumps(row)}", flush=True)
            cp_expect_launches(row["call"], row["launches"], CP_COLD,
                               tag="heal")
            if not svc.commit(rid):
                raise AssertionError(f"[heal] commit {key} refused")
        t0 = time.perf_counter()
        world = HealWorld(kit, store, svc, slugs)
        for fl in flows:
            world.deploy(fl, "prod")
        seeded = world.fleet.take()
        print(f"[heal] {json.dumps(dict(setup='agents', agents=len(slugs), wall_ms=round((time.perf_counter() - t0) * 1e3, 3), containers=sum(len(a.backend.containers) for a in world.fleet.agents.values()), **seeded, card=card))}",
              flush=True)
        for key in keys:
            if world.misplaced(key):
                raise AssertionError(f"[heal] {key} not deployed")
        dead: set = set()
        heal_burst(torch, np, world, meter, (REGISTRY, verify), dev_name,
                   dead, [busiest_shared(svc, *keys)], "one node", card,
                   True, keys)
        both = set(svc.retained(keys[1])[1].assignment.values())
        live = sorted(n for n in both & set(
            svc.retained(keys[0])[1].assignment.values()) if n not in dead)
        rng = np.random.default_rng(1)
        burst = sorted(str(x) for x in rng.choice(live, burst2,
                                                  replace=False))
        heal_burst(torch, np, world, meter, (REGISTRY, verify), dev_name,
                   dead, burst, f"{burst2} nodes", card, False, keys)
    finally:
        meter.close()
        if world is not None:
            world.close()
    took = time.perf_counter() - t_phase
    print(f"[heal] {json.dumps(dict(phase_s=round(took, 3), budget_s=HEAL_BUDGET_S, over_budget=took > HEAL_BUDGET_S, card=card))}",
          flush=True)
    return read_launches(torch, _ext, "heal", CP_COLD,
                         off=("k6_greedy_scan",))


WORLD_SEED = 7
WORLD_POOL_MIN = 2
# the reference's acceptance-scale runs (tests/test_chaos.py TestFullPack)
WORLD_ACCEPTANCE = ("rolling-kill-selfheal", "cp-failover")
WORLD_ACCEPTANCE_SIZE = dict(services=1_000, nodes=100, stages=2)
WORLD_REPEAT = "rolling-kill-selfheal"   # run twice: one digest
WORLD_MEMORY_SLACK = 64 << 20            # bytes, after the failover run
WORLD_BUDGET_S = 300.0                   # the phase's time on the host


def world_sizing(chaos, name: str) -> dict:
    """A scenario's docstring sizing (services, nodes, stages)."""
    info = chaos.scenario_info(name)
    return {k: int(v) for k, v in (kv.split("=")
                                   for kv in info["sizing"].split())}


class WorldMeter:
    """Counts the card scheduler's solves of a chaos world and tallies the
    launches since the last solve at each solve's fleet size (every
    scheduler of the world, failovers included, is a GpuSolverScheduler:
    its place is wrapped on the class for the phase)."""

    def __init__(self, _ext, sched_cls):
        self._ext, self.cls = _ext, sched_cls
        self.place = sched_cls.place
        self.solves = 0
        self.since: Optional[dict] = None
        self.last_size: Optional[tuple] = None
        meter, place = self, self.place

        def counted(sched, pt, **kw):
            out = place(sched, pt, **kw)
            meter.solves += 1
            meter.last_size = (pt.S, pt.N)
            meter.since = tally_size(meter._ext, pt.S, pt.N, meter.since)
            return out
        sched_cls.place = counted

    def close(self) -> None:
        """Restore place; launches after the last solve go to its size."""
        self.cls.place = self.place
        if self.last_size is not None:
            self.since = tally_size(self._ext, *self.last_size, self.since)


def run_world_phase(torch, _ext, REGISTRY, card, device=None, runs=None):
    """[world]: the chaos world placing on the card. Each of `runs` (name,
    size) through ``chaos.run_scenario(name, seed=7, pool_min=2,
    device=device)``: by default every scenario of the pack at its sizing,
    the acceptance runs at 1,000 x 100 x 2, and WORLD_REPEAT at its pack
    size once more. A run fails the phase unless its report is ok (no
    violation listed) and the card scheduler served its solves with no
    host fallback (``fleet_placement_churn_fallbacks_total`` unmoved); a
    scenario run twice at one size must give one digest; over the phase
    K1, K3 and K4 launch, and K2 or K5. After the last ``cp-failover`` run
    and a collection, the card's allocated memory is within 64 MB of its
    value before the phase. Returns the phase's launch counts."""
    import gc

    from fleetflow_tpu_torch import chaos
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
    if runs is None:
        runs = ([(n, world_sizing(chaos, n)) for n in chaos.scenario_names()]
                + [(n, dict(WORLD_ACCEPTANCE_SIZE))
                   for n in WORLD_ACCEPTANCE])
        runs.append((WORLD_REPEAT, world_sizing(chaos, WORLD_REPEAT)))
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    _ext.reset_launches()
    meter = WorldMeter(_ext, GpuSolverScheduler)
    digests: dict = {}
    mem_after = None
    problems = []
    try:
        for name, size in runs:
            fb0, solves0 = fallbacks.value(), meter.solves
            seen = dict(_ext.LAUNCHES)
            t0 = time.perf_counter()
            r = chaos.run_scenario(name, seed=WORLD_SEED,
                                   pool_min=WORLD_POOL_MIN, device=device,
                                   **size)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                        if v != seen[k]}
            solves = meter.solves - solves0
            moved = fallbacks.value() - fb0
            digest = r.digest()
            label = f"{name}@{size['services']}x{size['nodes']}"
            digests.setdefault(label, []).append(digest)
            print(f"[world] {json.dumps(dict(scenario=name, size=[size['services'], size['nodes'], size['stages']], wall_s=round(wall, 3), ok=r.ok, violations=r.violations[:3], stats=r.stats, heals=r.stats['heals'], failovers=r.stats['failovers'], solves=solves, fallbacks=moved, launches=launched, digest=digest, card=card))}",
                  flush=True)
            if not r.ok:
                problems.append(f"{label}: violations {r.violations[:5]}")
            if moved:
                problems.append(f"{label}: {moved} host fallbacks")
            if not solves:
                problems.append(f"{label}: the card scheduler never solved")
            if name == "cp-failover":
                del r
                gc.collect()
                torch.cuda.synchronize()
                mem_after = torch.cuda.memory_allocated()
    finally:
        meter.close()
    for label, ds in digests.items():
        if len(set(ds)) != 1:
            problems.append(f"{label}: digests differ across runs {ds}")
    if not any(len(ds) > 1 for ds in digests.values()):
        problems.append("no run was repeated")
    took = time.perf_counter() - t_phase
    print(f"[world] {json.dumps(dict(memory_before=mem0, memory_after=mem_after, slack=WORLD_MEMORY_SLACK, repeated={k: v for k, v in digests.items() if len(v) > 1}, card=card))}",
          flush=True)
    if mem_after is None or abs(mem_after - mem0) > WORLD_MEMORY_SLACK:
        problems.append(f"allocated memory {mem0} -> {mem_after} after "
                        "cp-failover")
    if problems:
        raise AssertionError("[world] " + "; ".join(problems))
    print(f"[world] {json.dumps(dict(phase_s=round(took, 3), budget_s=WORLD_BUDGET_S, over_budget=took > WORLD_BUDGET_S, runs=len(runs), card=card))}",
          flush=True)
    launches = read_launches(torch, _ext, "world", CP_COLD,
                             off=("k6_greedy_scan",))
    cp_expect_launches("world", launches, ("k2_prerepair", "k5_subsolve"),
                       any_of=True, tag="world")
    return launches


WIRE_AGENTS = 100          # agents on the agent channel, one a node
WIRE_SERVICES = 1_000      # the deployed stage: the chaos world's make_flow
WIRE_FLOW_SEED = 7
WIRE_ARRIVALS = 64
WIRE_KILL = 50
WIRE_BUDGET_S = 120.0      # the phase's time on the card's host
WIRE_HEARTBEAT_S = 0.25
WIRE_CAPACITY = {"cpu": 4.0, "memory": 8192.0, "disk": 100_000.0}
# short leases, as the reference's self-heal end-to-end test sets them,
# with room for the loop that serves the agents' deploys too: a dropped
# session is dead after the suspect grace
WIRE_LEASE = dict(lease_s=4.0, suspect_grace_s=1.0, heal_interval_s=0.1,
                  heal_backoff_base_s=0.1, heal_backoff_max_s=1.0)
WIRE_STANDBY = dict(standby_lease_s=2.0, standby_grace_s=0.5,
                    standby_ping_interval_s=0.1)
WIRE_WAIT_S = 120.0        # the longest wait for admission, heal, catch-up
WIRE_SECRET = "fleetflow-chip-smoke"
WIRE_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "wire")
WIRE_CHANNELS = ("tenant", "project", "stage", "service", "container",
                 "server", "health", "cost", "dns", "deploy", "volume",
                 "build", "placement", "agent", "replication")


class WireAgent:
    """One node's agent on the wire: a ProtocolClient on the agent channel
    holding the agent contract (register with its capacity, heartbeat
    events, one ``command_result`` a command), executing each command
    through a SimAgent of HealAgents (a DeployEngine on its own
    MockBackend, the idempotency cache of the heal drive)."""

    def __init__(self, sim: SimAgent):
        self.sim, self.slug = sim, sim.slug
        self.conn = self.task = self.beat = None
        self.commands = 0

    async def connect(self, ProtocolClient, host: str, port: int,
                      token: Optional[str], ssl_context=None,
                      heartbeat_s: float = WIRE_HEARTBEAT_S) -> "WireAgent":
        async def on_command(conn, method, payload):
            request_id = payload.get("request_id")
            self.commands += 1
            try:
                reply = {"request_id": request_id, "result": self.sim.execute(
                    method, payload.get("payload", {}))}
            except Exception as e:   # errors ride back, as an agent's do
                reply = {"request_id": request_id, "error": str(e)}
            if request_id:
                await conn.send_event("agent", "command_result", reply)

        self.conn, self.task = await ProtocolClient.connect(
            host, port, identity=self.slug, token=token,
            ssl_context=ssl_context, event_handlers={"agent": on_command})
        reply = await self.conn.request("agent", "register", {
            "slug": self.slug, "version": "0.1.0",
            "capacity": dict(WIRE_CAPACITY)})
        if not reply.get("registered"):
            raise AssertionError(f"[wire] {self.slug} register: {reply}")
        self.beat = asyncio.ensure_future(self._heartbeats(heartbeat_s))
        return self

    async def _heartbeats(self, every: float) -> None:
        try:
            while True:
                await asyncio.sleep(every)
                await self.conn.send_event("agent", "heartbeat",
                                           {"version": "0.1.0"})
        except Exception:
            return               # the session is gone: so is the agent

    async def close(self) -> None:
        if self.beat is not None:
            self.beat.cancel()
        if self.conn is not None:
            await self.conn.close()
        if self.task is not None:
            self.task.cancel()
            try:
                await self.task
            except BaseException:
                pass


class WireMeter:
    """Wraps ``GpuSolverScheduler.place`` on the class for the phase: every
    scheduler's solve (the promoted standby's too) is timed and kept with
    its result, and the launches since the last solve are tallied at its
    fleet size."""

    def __init__(self, _ext, sched_cls):
        self._ext, self.cls, self.place = _ext, sched_cls, sched_cls.place
        self.solves: list = []     # (S, N, ms, SolveResult) since the take
        self.since: Optional[dict] = None
        self.last_size: Optional[tuple] = None
        self._lock = threading.Lock()
        meter, place = self, self.place

        def counted(sched, pt, **kw):
            t0 = time.perf_counter()
            out = place(sched, pt, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            with meter._lock:
                meter.solves.append((pt.S, pt.N, ms, sched.last_result))
                meter.last_size = (pt.S, pt.N)
                meter.since = tally_size(meter._ext, pt.S, pt.N, meter.since)
            return out
        sched_cls.place = counted

    def take(self) -> list:
        with self._lock:
            out, self.solves = self.solves, []
        return out

    def close(self) -> None:
        """Restore place; launches after the last solve go to its size."""
        self.cls.place = self.place
        if self.last_size is not None:
            self.since = tally_size(self._ext, *self.last_size, self.since)


class MeteredRpc:
    """One metered RPC of phase `tag`: its wall, the solver's ms and
    launches, printed as a line of the phase and kept in ``rows``."""

    def __init__(self, meter: WireMeter, _ext, tag: str, card: str):
        self.meter, self._ext, self.tag, self.card = meter, _ext, tag, card
        self.rows: list = []

    async def __call__(self, conn, label: str, channel: str, method: str,
                       payload: dict, want=(), any_of: bool = False,
                       **extra):
        _ext = self._ext
        self.meter.take()
        seen = dict(_ext.LAUNCHES)
        t0 = time.perf_counter()
        reply = await conn.request(channel, method, payload, timeout=600.0)
        wall = (time.perf_counter() - t0) * 1e3
        solves = self.meter.take()
        launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                    if v != seen[k]}
        row = dict(rpc=label, method=f"{channel}.{method}",
                   wall_ms=round(wall, 3),
                   reply_solve_ms=(round(reply["solve_ms"], 3)
                                   if "solve_ms" in reply else None),
                   solves=len(solves),
                   solve_ms=round(sum(s[2] for s in solves), 3),
                   sizes=sorted({f"{s[0]}x{s[1]}" for s in solves}),
                   launches=launched, **extra, card=self.card)
        print(f"[{self.tag}] {json.dumps(row)}", flush=True)
        self.rows.append(row)
        if want:
            cp_expect_launches(label, launched, want, any_of=any_of,
                               tag=self.tag)
        return reply, solves


def wire_errors(REGISTRY) -> dict:
    """``fleet_cp_request_errors_total`` by channel."""
    errors = REGISTRY.get("fleet_cp_request_errors_total")
    return {ch: errors.value(channel=ch) for ch in WIRE_CHANNELS}


def wire_misplaced(container_name, svc, agents: dict, key: str) -> list:
    """Rows of stage `key` with no running container on the backend of the
    agent (`agents` by slug) its retained placement names."""
    project, _, stage = key.partition("/")
    bad = []
    for row, node in svc.retained(key)[1].assignment.items():
        base, _, idx = row.partition("#")
        name = container_name(project, stage, base)
        info = agents[node].backend.inspect(f"{name}-{idx}" if idx else name)
        if info is None or not info.running:
            bad.append((row, node))
    return bad


async def wire_until(what: str, cond, timeout: float = WIRE_WAIT_S,
                     every: float = 0.05, tag: str = "wire") -> float:
    """Poll `cond()` until it holds; its seconds. Fails after `timeout`."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"[{tag}] {what}: not after {timeout} s")
        await asyncio.sleep(every)
    return time.perf_counter() - t0


def wire_tls_check(start, ServerConfig, ProtocolClient, MockBackend,
                   device) -> dict:
    """The server with its mesh CA (``tls_dir``) and tenant secrets sealed
    with a master key from the environment, reached through a client that
    pins the CA: a ping and a secret's round trip. Needs `cryptography`;
    without it, says so and checks nothing."""
    try:
        from fleetflow_tpu_torch.cp.cert import client_ssl_context
        from fleetflow_tpu_torch.cp.crypto import generate_master_key
    except ImportError as e:
        return dict(tls=False, reason=f"no cryptography ({e})")

    async def drive():
        with env_set(FLEETFLOW_MASTER_KEY=generate_master_key()):
            handle = await start(
                ServerConfig(name="fleetflow-cp-tls", auth_kind="token",
                             auth_secret=WIRE_SECRET,
                             tls_dir=os.path.join(WIRE_DIR, "ca"),
                             master_key_env=True, self_heal=False,
                             admission=False, collector=False,
                             device=device),
                backend_factory=lambda: MockBackend(auto_pull=True))
        try:
            token = handle.state.auth.issue("operator@chip-smoke",
                                            ["admin:all"])
            conn, task = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli", token=token,
                ssl_context=client_ssl_context(handle.ca_pem))
            t0 = time.perf_counter()
            pong = await conn.request("health", "ping")
            ping_ms = (time.perf_counter() - t0) * 1e3
            await conn.request("tenant", "secret.set", {
                "name": "acme", "key": "DB_PASS", "value": "hunter2"})
            got = await conn.request("tenant", "secret.get",
                                     {"name": "acme", "key": "DB_PASS"})
            sealed = handle.state.store.tenant_by_name("acme").secrets
            await conn.close()
            task.cancel()
        finally:
            await handle.stop()
        if (not pong.get("pong") or got.get("value") != "hunter2"
                or sealed.get("DB_PASS") == "hunter2"):
            raise AssertionError(f"[wire] tls: ping {pong}, secret {got}")
        return dict(tls=True, ping_ms=round(ping_ms, 3), sealed=True)

    return asyncio.run(drive())


def run_wire_phase(torch, np, _ext, REGISTRY, verify, dev_name, flow, pool,
                   card, device=None, agents=WIRE_AGENTS,
                   services=WIRE_SERVICES, arrivals=WIRE_ARRIVALS,
                   kill=WIRE_KILL):
    """[wire]: a control-plane server on a TCP socket placing on the card.
    ``start(ServerConfig(auth_kind="token", self_heal=True, admission=True,
    collector=True))`` on 127.0.0.1 (the card unless `device` names
    another, for a rehearsal), reached by token-authenticated
    ProtocolClients: [frontend]'s servers registered through
    ``server.register`` with their capacities and labels and marked up
    through ``placement.node_events``; ``placement.solve`` of [frontend]'s
    fleet with a reservation, ``commit``; ``node_events`` with the busiest
    node down, then `kill` more; ``explain`` of a port row;
    ``health solver.slots``; ``deploy.submit`` of `arrivals` arrivals,
    ``admit_status`` polled until they are admitted. Then `agents`
    WireAgents register, ``deploy.execute`` places a `services`-service
    stage onto them and fans it out; the busiest agent's session closes,
    and the reconverger re-places and redeploys its rows on the
    survivors. A standby of the server catches up on the journal, the
    server stops, the standby promotes and solves [frontend]'s fleet on
    a fresh scheduler. Where `cryptography` imports, a server with its
    mesh CA and a master key is also reached through a pinned client
    (wire_tls_check).

    Fails unless every RPC answers without error and
    ``fleet_cp_request_errors_total`` stands still; every placement has 0
    violations, nothing on a dead node and the card's ``gpu-anneal``
    source, solved on `dev_name`; the churn-fallback counter stands
    still; every row of the deployed stage runs on its placed live node
    after the heal; K4, K3 and K1 launch, and K2 or K5; and, after both
    servers stop, the card's allocated memory is within 64 MB of its
    value before the phase. Prints each RPC's wall ms beside the
    solver's ms, the heal's and the promotion's seconds and the phase's
    seconds against its budget. Returns the phase's launch counts."""
    import gc

    from fleetflow_tpu_torch.chaos.runner import make_flow, node_slug
    from fleetflow_tpu_torch.core.serialize import flow_to_dict
    from fleetflow_tpu_torch.cp import ServerConfig, start
    from fleetflow_tpu_torch.cp.protocol import ProtocolClient
    from fleetflow_tpu_torch.obs.slo import get_engine, set_engine
    from fleetflow_tpu_torch.runtime import DeployRequest, MockBackend
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
    t_phase = time.perf_counter()
    kit = heal_kit()
    tls = wire_tls_check(start, ServerConfig, ProtocolClient, MockBackend,
                         device)
    print(f"[wire] tls {json.dumps(dict(tls, card=card))}", flush=True)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    fb0, err0 = fallbacks.value(), wire_errors(REGISTRY)
    engine0 = get_engine()
    _ext.reset_launches()
    meter = WireMeter(_ext, GpuSolverScheduler)
    key0 = f"{flow.name}/prod"
    rpc = MeteredRpc(meter, _ext, "wire", card)
    rows = rpc.rows

    def check(svc, dead: set, solves: list, label: str) -> None:
        cp_check(np, svc, verify, dev_name, dead,
                 SimpleNamespace(results=[s[3] for s in solves]), label,
                 card, tag="wire")

    async def drive() -> dict:
        out: dict = {}
        primary = await start(
            ServerConfig(auth_kind="token", auth_secret=WIRE_SECRET,
                         self_heal=True, admission=True, collector=True,
                         device=device, **WIRE_LEASE),
            backend_factory=lambda: MockBackend(auto_pull=True))
        svc = primary.state.placement
        admin = primary.state.auth.issue("operator@chip-smoke",
                                         ["admin:all"])
        cli, cli_task = await ProtocolClient.connect(
            primary.host, primary.port, identity="cli", token=admin)
        wire = []
        standby = None
        stopped = False
        try:
            # [frontend]'s servers, as an operator registers them
            t0 = time.perf_counter()
            regs = await asyncio.gather(*(cli.request("server", "register", {
                "slug": srv.name, "hostname": srv.name,
                "capacity": {"cpu": srv.capacity.cpu,
                             "memory": srv.capacity.memory,
                             "disk": srv.capacity.disk},
                "labels": {"tier": srv.labels.tier,
                           "region": srv.labels.region,
                           "class": srv.labels.clazz,
                           "arch": srv.labels.arch,
                           "extra": dict(srv.labels.extra)}})
                for srv in pool.servers.values()))
            row = dict(rpc=f"server.register x{len(regs)}",
                       wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                       card=card)
            print(f"[wire] {json.dumps(row)}", flush=True)
            rows.append(row)
            await rpc(cli, f"node_events {len(regs)} up", "placement",
                      "node_events", {"events": [
                          {"slug": srv.name, "online": True}
                          for srv in pool.servers.values()]})

            fd = flow_to_dict(flow)
            rep, solves = await rpc(
                cli, f"solve {key0}", "placement", "solve",
                {"flow": fd, "stage": "prod", "reserve": True},
                want=CP_COLD, rows=len(flow.services))
            if (not rep["feasible"] or rep["violations"]
                    or rep["source"] != "gpu-anneal"):
                raise AssertionError(f"[wire] solve: feasible "
                                     f"{rep['feasible']}, violations "
                                     f"{rep['violations']}, {rep['source']}")
            ok, _ = await rpc(cli, f"commit {key0}", "placement", "commit",
                              {"reservation": rep["reservation"]})
            if not ok["ok"]:
                raise AssertionError(f"[wire] commit refused: {ok}")
            dead: set = set()
            check(svc, dead, solves, f"solve {key0}")

            counts: dict = {}
            for node in rep["assignment"].values():
                counts[node] = counts.get(node, 0) + 1
            victim = max(sorted(counts), key=counts.get)
            rng = np.random.default_rng(0)
            alive = sorted(s for s in (srv.name for srv in
                                       pool.servers.values())
                           if s != victim)
            burst = [str(x) for x in rng.choice(alive, kill, replace=False)]
            for label, slugs in (("node_events one node", [victim]),
                                 (f"node_events {kill} nodes", burst)):
                dead |= set(slugs)
                moved, solves = await rpc(
                    cli, label, "placement", "node_events",
                    {"events": [{"slug": s, "online": False}
                                for s in slugs]},
                    want=CP_WARM, any_of=True, events=len(slugs))
                stages = [m["stage"] for m in moved["rescheduled"]]
                if stages != [key0] or not all(
                        m["feasible"] for m in moved["rescheduled"]):
                    raise AssertionError(f"[wire] {label}: {moved}")
                check(svc, dead, solves, label)

            pt, _pl = svc.retained(key0)
            row_i = int(np.flatnonzero((pt.port_ids >= 0).any(1))[0])
            name = pt.service_names[row_i]
            why, _ = await rpc(cli, f"explain {name}", "placement", "explain",
                               {"stage": key0, "service": name})
            if not why["chosen"]["feasible"] or why["source"] != "gpu-anneal":
                raise AssertionError(f"[wire] explain: {why}")
            slots, _ = await rpc(cli, "solver.slots", "health",
                                 "solver.slots", {})
            print(f"[wire] slots {json.dumps(dict(resident=[s['stage'] for s in slots['slots']], resident_bytes=slots['resident_bytes'], budget_bytes=slots['budget_bytes'], card=card))}",
                  flush=True)

            # streaming admission over the wire
            names = [f"wire-arrival-{i:03d}" for i in range(arrivals)]
            meter.take()
            seen = dict(_ext.LAUNCHES)
            t0 = time.perf_counter()
            sub = await cli.request("deploy", "submit", {
                "tenant": "t0", "stage": "prod", "flow": fd,
                "arrivals": [{"name": n, "cpu": 0.25, "memory": 256.0,
                              "disk": 512.0} for n in names]},
                timeout=600.0)
            submit_ms = (time.perf_counter() - t0) * 1e3
            polls = 0
            while True:
                st = await cli.request("deploy", "admit_status", {})
                polls += 1
                if st["stats"]["admitted"] >= arrivals:
                    break
                if time.perf_counter() - t0 > WIRE_WAIT_S:
                    raise AssertionError(f"[wire] admission: {st}")
                await asyncio.sleep(0.05)
            wall = (time.perf_counter() - t0) * 1e3
            solves = meter.take()
            launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                        if v != seen[k]}
            live = set(svc.retained(key0)[1].assignment)
            row = dict(rpc=f"deploy.submit {arrivals} arrivals",
                       method="deploy.submit", submit_ms=round(submit_ms, 3),
                       wall_ms=round(wall, 3), polls=polls,
                       accepted=sub.get("accepted"), solves=len(solves),
                       solve_ms=round(sum(s[2] for s in solves), 3),
                       admitted=st["stats"]["admitted"],
                       parked=st["parked"], launches=launched, card=card)
            print(f"[wire] {json.dumps(row)}", flush=True)
            rows.append(row)
            if not set(names) <= live:
                raise AssertionError(f"[wire] admitted rows missing: "
                                     f"{sorted(set(names) - live)[:5]}")
            cp_expect_launches(row["rpc"], launched, CP_WARM, any_of=True,
                               tag="wire")
            check(svc, dead, solves, row["rpc"])

            # agents on the agent channel, a stage deployed onto them
            slugs = [node_slug(i) for i in range(agents)]
            fleet = HealAgents(kit, slugs, None,
                               SimpleNamespace(advance=lambda s: None))
            t0 = time.perf_counter()
            wire.extend(await asyncio.gather(*(
                WireAgent(fleet.agents[s]).connect(
                    ProtocolClient, primary.host, primary.port,
                    primary.state.auth.issue(s, ["write:agent"]))
                for s in slugs)))
            row = dict(rpc=f"agent.register x{agents}",
                       wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                       card=card)
            print(f"[wire] {json.dumps(row)}", flush=True)
            rows.append(row)
            flow2 = make_flow(services, 1, slugs, WIRE_FLOW_SEED)
            key1 = f"{flow2.name}/app0"
            req = DeployRequest(flow=flow2, stage_name="app0")
            dep, solves = await rpc(
                cli, f"deploy.execute {key1}", "deploy", "execute",
                {"request": req.to_dict()}, want=CP_COLD,
                agents=len(slugs))
            if dep["deployment"]["status"] != "succeeded":
                raise AssertionError(f"[wire] deploy: {dep['deployment']}")
            check(svc, dead, solves, f"deploy.execute {key1}")
            bad = wire_misplaced(kit.container_name, svc, fleet.agents,
                                 key1)
            if bad:
                raise AssertionError(f"[wire] deployed rows not running: "
                                     f"{bad[:5]}")

            # a heal: the busiest agent's session closes
            counts = {}
            for node in dep["deployment"]["placement"].values():
                counts[node] = counts.get(node, 0) + 1
            gone = max(sorted(counts), key=counts.get)
            by_slug = {a.slug: a for a in wire}
            rc = primary.state.reconverger
            meter.take()
            seen = dict(_ext.LAUNCHES)
            t_kill = time.perf_counter()
            await by_slug[gone].close()

            def healed() -> bool:
                entry = svc.retained(key1)
                return (entry is not None
                        and gone not in entry[1].assignment.values()
                        and rc.debt() == 0 and not rc.parked_stage_keys()
                        and not wire_misplaced(kit.container_name, svc,
                                               fleet.agents, key1))
            heal_s = await wire_until("heal", healed)
            solves = meter.take()
            launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                        if v != seen[k]}
            dead.add(gone)
            status = rc.status()
            heals = [d for d in primary.state.store.list("deployments")
                     if d.log.startswith("self-heal")]
            row = dict(rpc=f"heal {gone}", heal_s=round(heal_s, 3),
                       rows_moved=counts[gone], solves=len(solves),
                       solve_ms=round(sum(s[2] for s in solves), 3),
                       sizes=sorted({f"{s[0]}x{s[1]}" for s in solves}),
                       redeliveries_ok=status["stats"].get(
                           "redeliveries_ok"),
                       heal_records=len(heals), launches=launched,
                       card=card)
            print(f"[wire] {json.dumps(row)}", flush=True)
            rows.append(row)
            if not heals:
                raise AssertionError("[wire] heal: no self-heal record")
            cp_expect_launches(row["rpc"], launched, CP_WARM, any_of=True,
                               tag="wire")
            check(svc, dead, solves, row["rpc"])
            out["heal_s"] = heal_s

            # a standby: catches up on the journal, promotes when the
            # primary stops, and solves on a fresh scheduler
            standby = await start(
                ServerConfig(name="fleetflow-cp-standby",
                             standby_of=f"{primary.host}:{primary.port}",
                             standby_token=admin, auth_kind="token",
                             auth_secret=WIRE_SECRET, device=device,
                             **WIRE_STANDBY),
                backend_factory=lambda: MockBackend(auto_pull=True))
            seq = primary.state.store.seq
            catch_s = await wire_until(
                "standby catch-up", lambda: standby.state.store.seq >= seq)
            out["errors_before_stop"] = wire_errors(REGISTRY)
            await cli.close()
            cli_task.cancel()
            t0 = time.perf_counter()
            await primary.stop()
            stop_s = time.perf_counter() - t0
            promote_s = await wire_until(
                "promotion",
                lambda: standby.state.replication_role == "primary")
            stopped = True
            for a in wire:
                await a.close()
            row = dict(rpc="promotion", catch_up_s=round(catch_s, 3),
                       seq=seq, primary_stop_s=round(stop_s, 3),
                       promote_s=round(promote_s, 3),
                       epoch=standby.state.store.epoch, card=card)
            print(f"[wire] {json.dumps(row)}", flush=True)
            rows.append(row)
            out["promote_s"] = promote_s
            cli, cli_task = await ProtocolClient.connect(
                standby.host, standby.port, identity="cli", token=admin)
            rep, solves = await rpc(
                cli, f"promoted solve {key0}", "placement", "solve",
                {"flow": fd, "stage": "prod", "reserve": True},
                want=CP_COLD, rows=len(flow.services))
            if (not rep["feasible"] or rep["violations"]
                    or rep["source"] != "gpu-anneal" or not solves):
                raise AssertionError(f"[wire] promoted solve: feasible "
                                     f"{rep['feasible']}, violations "
                                     f"{rep['violations']}, {rep['source']}")
            await rpc(cli, f"promoted commit {key0}", "placement", "commit",
                      {"reservation": rep["reservation"]})
            # the promoted service's other stages are the dead primary's
            # committed book, rehydrated: the solve is the stage to hold
            pt, pl = standby.state.placement.retained(key0)
            raw = np.asarray(pl.raw)
            on_dead = sorted(set(pl.assignment.values()) & dead)
            if (verify(pt, raw)["total"] or (~pt.node_valid[raw]).any()
                    or on_dead or pl.source != "gpu-anneal"
                    or any(s[3].device != dev_name for s in solves)):
                raise AssertionError(
                    f"[wire] promoted solve: {pl.source}, on dead nodes "
                    f"{on_dead[:5]}, devices "
                    f"{[s[3].device for s in solves]}")
            await cli.close()
            cli_task.cancel()
        finally:
            for a in wire:
                await a.close()
            if standby is not None:
                await standby.stop()
            if not stopped:
                await primary.stop()
        return out

    try:
        out = asyncio.run(drive())
    finally:
        meter.close()
        set_engine(engine0)
    torch.cuda.synchronize()
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    err1 = wire_errors(REGISTRY)
    moved = fallbacks.value() - fb0
    errors = {ch: err1[ch] - err0[ch] for ch in WIRE_CHANNELS
              if err1[ch] != err0[ch]}
    took = time.perf_counter() - t_phase
    print(f"[wire] {json.dumps(dict(errors=errors, fallbacks=moved, memory_before=mem0, memory_after=mem_after, slack=WORLD_MEMORY_SLACK, card=card))}",
          flush=True)
    problems = []
    if errors:
        problems.append(f"request errors by channel {errors}")
    if moved:
        problems.append(f"{moved} churn fallbacks")
    if abs(mem_after - mem0) > WORLD_MEMORY_SLACK:
        problems.append(f"allocated memory {mem0} -> {mem_after}")
    if problems:
        raise AssertionError("[wire] " + "; ".join(problems))
    launches = read_launches(torch, _ext, "wire", CP_COLD,
                             off=("k6_greedy_scan",))
    cp_expect_launches("wire", launches, CP_WARM, any_of=True, tag="wire")
    print(f"[wire] {json.dumps(dict(phase_s=round(took, 3), budget_s=WIRE_BUDGET_S, over_budget=took > WIRE_BUDGET_S, heal_s=round(out['heal_s'], 3), promote_s=round(out['promote_s'], 3), rpcs=len(rows), launches=launches, card=card))}",
          flush=True)
    return launches


REGISTRY_FLEETS = 8        # tenant fleets t0..t7 (bench.py:1070-1108)
REGISTRY_SERVICES = 1_250  # services a fleet: BASELINE config 4's 10k
REGISTRY_NODES = 1_000
REGISTRY_TRIM = 17         # the churn shape: t0 with 17 fewer (bench.py:1191)
REGISTRY_WORKERS = 4       # FLEET_PARSE_WORKERS: the fork pool of loaders
REGISTRY_BUDGET_S = 60.0   # the phase's time on the card's host
REGISTRY_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "registry")


def registry_fleet_text(fleetgen, i: int, services: int, nodes: int,
                        trim: int = 0) -> str:
    """Fleet t{i} of the reference bench's generated registry, `trim`
    services short (its churn shape regenerates the fleet)."""
    return fleetgen.generate_fleet_kdl(f"t{i}", services - trim,
                                       seed=100 + i, n_nodes_hint=nodes,
                                       port_base=10000 + i * services)


def registry_write(fleetgen, root: str, services: int, nodes: int,
                   fleets: int = REGISTRY_FLEETS) -> None:
    """The fleets as project directories under `root` and a
    fleet-registry.kdl beside them: one ``fleet`` node a fleet and the
    generated server pool."""
    lines = []
    for i in range(fleets):
        proj = os.path.join(root, f"t{i}")
        os.makedirs(os.path.join(proj, ".fleetflow"), exist_ok=True)
        with open(os.path.join(proj, ".fleetflow", "fleet.kdl"), "w") as f:
            f.write(registry_fleet_text(fleetgen, i, services, nodes))
        lines.append(f'fleet "t{i}" path="{os.path.abspath(proj)}"')
    lines.append(fleetgen.generate_servers_kdl(nodes, seed=7))
    with open(os.path.join(root, "fleet-registry.kdl"), "w") as f:
        f.write("\n".join(lines) + "\n")


def registry_slices_cover(np, index, pt, raw) -> int:
    """``AggregateIndex.slices_for_node`` over every node covers every row
    exactly once. Returns the nodes holding a slice."""
    from collections import Counter
    seen: Counter = Counter()
    holding = 0
    for node in pt.node_names:
        slices = index.slices_for_node(pt, raw, node)
        holding += bool(slices)
        for (fleet, stage), names in slices.items():
            seen.update((fleet, stage, n) for n in names)
    if seen != Counter(index.rows) or sum(seen.values()) != pt.S:
        raise AssertionError(f"[registry] node slices cover "
                             f"{sum(seen.values())} rows of {pt.S}")
    return holding


def registry_unforced_moves(np, pt, index, before, after,
                            edited: set) -> dict:
    """The warm re-place's moves against `before`, row by row name. A row
    is forced when it belongs to an edited fleet, `before` has no node for
    it, or the node `before` gave it is invalid or ineligible for it or,
    with the named rows alone on their nodes, over a capacity or holding a
    conflict, or, where those rows break the spread rule, in a zone above
    the emptiest one (only such a row can mend it). Returns the counts;
    ``unforced`` must be 0."""
    from fleetflow_tpu_torch.solver.repair import _group_counts, _unified_ids
    node_idx = {n: j for j, n in enumerate(pt.node_names)}
    mapped = np.array([node_idx.get(before.assignment.get(n), -1)
                       for n in pt.service_names], dtype=np.int64)
    named = mapped >= 0
    at = np.where(named, mapped, 0)
    load = np.zeros((pt.N, pt.demand.shape[1]))
    np.add.at(load, at[named], pt.demand[named].astype(np.float64))
    bad_node = (load > pt.capacity * (1 + 1e-6)).any(1)
    ids = _unified_ids(pt)
    G = int(ids.max(initial=-1)) + 1
    if G:
        bad_node |= (_group_counts(at[named], ids[named], pt.N, G)
                     > 1).any(1)
    edit = np.array([r[0] in edited for r in index.rows], dtype=bool)
    forced = (~named | bad_node[at] | ~pt.node_valid[at]
              | ~pt.eligible[np.arange(pt.S), at] | edit)
    spread = 0
    if pt.max_skew > 0:
        zone = pt.node_topology
        per = np.bincount(zone[at[named]], minlength=int(zone.max()) + 1)
        if per.max() - per.min() > pt.max_skew:
            spread = named & (per[zone[at]] > per.min())
            forced |= spread
            spread = int(spread.sum())
    moved = named & (np.asarray(after.raw) != mapped)
    return dict(moved=int(moved.sum()), kept=int((named & ~moved).sum()),
                unnamed=int((~named).sum()), edited=int(edit.sum()),
                forced=int(forced.sum()), bad_nodes=int(bad_node.sum()),
                spread_forced=spread,
                unforced=int((moved & ~forced).sum()))


def run_registry_phase(torch, np, _ext, REGISTRY, dev_name, card,
                       device=None, root=REGISTRY_DIR,
                       services=REGISTRY_SERVICES, nodes=REGISTRY_NODES,
                       trim=REGISTRY_TRIM, workers=REGISTRY_WORKERS,
                       expect=CP_COLD) -> dict:
    """[registry]: BASELINE config 4's multi-tenant instance from a
    registry, placed on the card. REGISTRY_FLEETS fleetgen fleets of
    `services` services (the reference bench's pipeline shape,
    bench.py:1070-1108) as project directories under `root`, with a
    fleet-registry.kdl of `nodes` generated servers; ``find_registry`` →
    ``parse_registry_file`` → ``aggregate_fleets(reg, stages=prod,
    cache=FlowCache())`` with the default loader and stage hash under
    FLEET_PARSE_WORKERS=`workers` (a fork pool in a process that holds a
    CUDA context) → ``GpuSolverScheduler().place``. Then fleet t0 is
    regenerated `trim` services short, re-aggregated through the same
    FlowCache (one fleet-stage missing, the others hitting) and re-placed
    with ``reschedule`` on the same stage key, which seeds from the cold
    placement by row name (``sched.gpu.seed_by_name``; its host ms timed
    apart from the solve's).

    Fails unless both placements have 0 violations (the host verify too),
    source ``gpu-anneal``, solved on `dev_name`; the warm place moves no
    row the edit did not force (registry_unforced_moves); the node slices
    cover every row once; the kernels of `expect` launch, and K2 or K5 on
    the warm re-place; ``fleet_frontend_phase_ms{phase="lower"}`` is set.
    Prints the rows × nodes, the pool's load ms, ``lower_stage``'s ms, the
    aggregation's ms (the gauge), the cold and warm place ms with the
    solver's ``timings_ms`` and the warm seed's host ms, the cache stats
    and the launches, and the phase's seconds against its budget.
    Returns the phase's launch counts and numbers."""
    import shutil

    from fleetflow_tpu_torch.lower import fleetgen
    from fleetflow_tpu_torch.registry import (aggregate_fleets,
                                              find_registry,
                                              parse_registry_file)
    from fleetflow_tpu_torch.registry import aggregate as agg
    from fleetflow_tpu_torch.registry.aggregate import FlowCache
    from fleetflow_tpu_torch.sched import gpu as sched_gpu
    from fleetflow_tpu_torch.solver.repair import verify
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    registry_write(fleetgen, root, services, nodes)
    fleets = [f"t{i}" for i in range(REGISTRY_FLEETS)]
    gauge = REGISTRY.get("fleet_frontend_phase_ms")
    gauge.set(-1.0, phase="lower")
    timed: dict = {}

    def timing(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timed[name] = timed.get(name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
        return wrapped

    def aggregate(reg, cache):
        timed.clear()
        pool, low = agg._parallel_load_rows, agg.lower_stage
        agg._parallel_load_rows = timing("pool_load_ms", pool)
        agg.lower_stage = timing("lower_ms", low)
        try:
            before = cache.stats()
            t0 = time.perf_counter()
            pt, index = aggregate_fleets(reg, stages={f: ["prod"]
                                                      for f in fleets},
                                         cache=cache)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            agg._parallel_load_rows, agg.lower_stage = pool, low
        after = cache.stats()
        return pt, index, dict(
            rows=[pt.S, pt.N], aggregate_ms=round(wall, 3),
            gauge_lower_ms=round(gauge.value(phase="lower"), 3),
            **{k: round(v, 3) for k, v in timed.items()},
            hits=after["hits"] - before["hits"],
            misses=after["misses"] - before["misses"])

    def check(label, pt, placed, res):
        host = verify(pt, np.asarray(placed.raw))
        if (not placed.feasible or placed.violations or host["total"]
                or placed.source != "gpu-anneal" or res.device != dev_name
                or res.pre_repair_violations):
            raise AssertionError(
                f"[registry] {label}: feasible {placed.feasible}, "
                f"violations {placed.violations} "
                f"({res.pre_repair_violations} before the host repair), "
                f"host {host}, {placed.source} on {res.device}")

    _ext.reset_launches()
    with env_set(FLEET_PARSE_WORKERS=str(workers)):
        t0 = time.perf_counter()
        path = find_registry(root)
        reg = parse_registry_file(str(path))
        reg_ms = (time.perf_counter() - t0) * 1e3
        cache = FlowCache()
        pt, index, cold_row = aggregate(reg, cache)
    if cold_row["misses"] != len(fleets) or cold_row["gauge_lower_ms"] <= 0:
        raise AssertionError(f"[registry] cold aggregation: {cold_row}")
    def solver_ms(res):
        return {k: round(v, 3) for k, v in res.timings_ms.items()}

    sched = sched_gpu.GpuSolverScheduler(device=device)
    t0 = time.perf_counter()
    cold = sched.place(pt, stage="registry")
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_res = sched.last_result
    check("cold", pt, cold, cold_res)
    holding = registry_slices_cover(np, index, pt, cold.raw)
    cold_launch = dict(_ext.LAUNCHES)
    cp_expect_launches("cold", cold_launch, expect, tag="registry")
    print(f"[registry] {json.dumps(dict(step='cold', registry_ms=round(reg_ms, 3), **cold_row, solve_ms=round(cold_ms, 3), solver_ms=solver_ms(cold_res), sweeps=cold_res.steps, nodes_holding=holding, launches=cold_launch, card=card))}",
          flush=True)
    tally_size(_ext, pt.S, pt.N)

    # the one-fleet edit: t0 regenerated `trim` services short
    with open(os.path.join(root, "t0", ".fleetflow", "fleet.kdl"), "w") as f:
        f.write(registry_fleet_text(fleetgen, 0, services, nodes, trim))
    with env_set(FLEET_PARSE_WORKERS=str(workers)):
        pt2, index2, warm_row = aggregate(reg, cache)
    if warm_row["misses"] != 1 or warm_row["hits"] != len(fleets) - 1:
        raise AssertionError(f"[registry] re-aggregation: {warm_row}")
    seen = dict(_ext.LAUNCHES)
    seeder = sched_gpu.seed_by_name
    sched_gpu.seed_by_name = timing("host_seed_ms", seeder)
    try:
        t0 = time.perf_counter()
        warm = sched.reschedule(pt2, stage="registry")
        warm_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sched_gpu.seed_by_name = seeder
    seed_ms = timed.pop("host_seed_ms", None)
    res = sched.last_result
    check("warm", pt2, warm, res)
    if seed_ms is None:
        raise AssertionError("[registry] the warm re-place did not seed "
                             "from the cold placement by row name")
    launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                if v != seen[k]}
    if expect:
        cp_expect_launches("warm", launched, CP_WARM, any_of=True,
                           tag="registry")
    moves = registry_unforced_moves(np, pt2, index2, cold, warm, {"t0"})
    if moves["unforced"]:
        raise AssertionError(f"[registry] warm re-place: {moves}")
    holding = registry_slices_cover(np, index2, pt2, warm.raw)
    print(f"[registry] {json.dumps(dict(step='warm', **warm_row, solve_ms=round(warm_ms, 3), host_seed_ms=round(seed_ms, 3), solver_ms=solver_ms(res), sweeps=res.steps, pre_repair_violations=res.pre_repair_violations, **moves, nodes_holding=holding, cache=cache.stats(), launches=launched, card=card))}",
          flush=True)
    tally_size(_ext, pt2.S, pt2.N, seen)
    del sched
    launches = read_launches(torch, _ext, "registry", expect,
                             off=("k6_greedy_scan",))
    took = time.perf_counter() - t_phase
    out = dict(phase_s=round(took, 3), budget_s=REGISTRY_BUDGET_S,
               over_budget=took > REGISTRY_BUDGET_S, rows=[pt.S, pt.N],
               parse_registry_ms=round(reg_ms, 3),
               pool_load_ms=cold_row.get("pool_load_ms"),
               lower_ms=cold_row.get("lower_ms"),
               aggregate_ms=cold_row["aggregate_ms"],
               cold_solve_ms=round(cold_ms, 3),
               cold_solver_total_ms=round(cold_res.timings_ms["total_ms"], 3),
               warm_aggregate_ms=warm_row["aggregate_ms"],
               warm_solve_ms=round(warm_ms, 3),
               warm_host_seed_ms=round(seed_ms, 3),
               warm_solver_total_ms=round(res.timings_ms["total_ms"], 3),
               cache=cache.stats(),
               unforced=moves["unforced"], launches=launches, card=card)
    print(f"[registry] {json.dumps(out)}", flush=True)
    return out


AGENT_BUDGET_S = 90.0      # the phase's time on the card's host
AGENT_HEARTBEAT_S = 0.5    # each agent's heartbeat (the lease is 4 s)
AGENT_MONITOR_S = 2.0      # each agent's inventory pass
AGENT_SIDE_SERVICES = 10   # the quadlet and compose stages (no replicas)
AGENT_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "agent")


def counter_total(counter) -> float:
    """A counter's value summed over its label sets."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in counter.samples())


class Recorder:
    """A recording shell-out (systemctl, docker compose): every argv is
    kept and answered with rc 0."""

    def __init__(self, output: str = ""):
        self.calls: list = []
        self.output = output

    def __call__(self, argv) -> tuple:
        self.calls.append(list(argv))
        return 0, self.output


def run_agent_phase(torch, np, _ext, REGISTRY, verify, dev_name, card,
                    device=None, agents=WIRE_AGENTS, services=WIRE_SERVICES,
                    root=AGENT_DIR, expect=CP_COLD) -> dict:
    """[agent]: real port agents behind a control-plane server that places
    on the card. ``cp.start(ServerConfig(auth_kind="token", self_heal=True))``
    on 127.0.0.1 with [wire]'s leases; `agents` ``Agent``s
    (``AgentConfig(slug=node_slug(i), token=...)``, each on its own
    ``MockBackend``) run their reconnect loops, register, heartbeat and
    ship inventory. ``deploy.execute`` of [wire]'s `services`-service stage
    (``chaos.runner.make_flow``) is placed on the card and fanned out; each
    agent executes its own slice through ``_placement_from``. The busiest
    agent stops; the reconverger re-places its rows on the card and
    redeploys them onto the survivors. A ``backend "quadlet"`` stage and a
    ``backend "compose"`` stage deploy onto one agent each, through a
    recording systemctl and compose runner; ``container.restart``,
    ``server.ping`` and the agent's ``status`` answer.

    Fails unless every RPC and command answers without error,
    ``fleet_cp_request_errors_total`` and ``fleet_agent_command_errors_total``
    stand still, no host fallback is counted; every placement is
    ``gpu-anneal`` on `dev_name` with 0 violations; every row of the
    stage runs on the agent of its placed live node, each agent holding
    its slice and nothing else, before and after the heal; the quadlet
    units written equal ``build_stage_units``, the compose file
    ``generate_compose_yaml``; the kernels of `expect` launch; and the
    card's allocated memory after the server stops is within 64 MB of
    its value before the phase. Prints each RPC, the deploy's and the
    heal's seconds and the phase's seconds against its budget."""
    import gc
    import shutil

    from fleetflow_tpu_torch.agent import Agent, AgentConfig
    from fleetflow_tpu_torch.chaos.runner import make_flow, node_slug
    from fleetflow_tpu_torch.core.model import Backend
    from fleetflow_tpu_torch.cp import ServerConfig, handlers, start
    from fleetflow_tpu_torch.cp.protocol import ProtocolClient
    from fleetflow_tpu_torch.obs.slo import get_engine, set_engine
    from fleetflow_tpu_torch.runtime import DeployRequest, MockBackend
    from fleetflow_tpu_torch.runtime.compose import generate_compose_yaml
    from fleetflow_tpu_torch.runtime.converter import container_name
    from fleetflow_tpu_torch.runtime.quadlet import build_stage_units
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
    del handlers     # imported for its request families, read below
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    cmd_errors = REGISTRY.get("fleet_agent_command_errors_total")
    heartbeats = REGISTRY.get("fleet_heartbeats_total")
    fb0, err0 = fallbacks.value(), wire_errors(REGISTRY)
    cmd0, hb0 = counter_total(cmd_errors), heartbeats.value()
    engine0 = get_engine()
    _ext.reset_launches()
    meter = WireMeter(_ext, GpuSolverScheduler)
    rpc = MeteredRpc(meter, _ext, "agent", card)
    systemctl, compose = Recorder(), Recorder("Container started")

    def check(svc, dead: set, solves: list, label: str) -> None:
        cp_check(np, svc, verify, dev_name, dead,
                 SimpleNamespace(results=[s[3] for s in solves]), label,
                 card, tag="agent")

    async def drive() -> dict:
        out: dict = {}
        handle = await start(
            ServerConfig(auth_kind="token", auth_secret=WIRE_SECRET,
                         self_heal=True, device=device, **WIRE_LEASE),
            backend_factory=lambda: MockBackend(auto_pull=True))
        svc, reg = handle.state.placement, handle.state.agent_registry
        admin = handle.state.auth.issue("operator@chip-smoke", ["admin:all"])
        cli, cli_task = await ProtocolClient.connect(
            handle.host, handle.port, identity="cli", token=admin)
        slugs = [node_slug(i) for i in range(agents)]
        fleet: dict = {}
        tasks: dict = {}
        try:
            t0 = time.perf_counter()
            for s in slugs:
                fleet[s] = Agent(
                    AgentConfig(cp_host=handle.host, cp_port=handle.port,
                                slug=s, token=handle.state.auth.issue(
                                    s, ["write:agent"]),
                                heartbeat_interval_s=AGENT_HEARTBEAT_S,
                                monitor_interval_s=AGENT_MONITOR_S,
                                reconnect_backoff_s=0.5,
                                capacity=dict(WIRE_CAPACITY),
                                deploy_base=os.path.join(root, "deploys", s),
                                quadlet_unit_dir=os.path.join(root, "units",
                                                              s)),
                    backend=MockBackend(auto_pull=True),
                    sleep=lambda d: None, systemctl=systemctl,
                    compose_runner=compose)
                tasks[s] = asyncio.ensure_future(fleet[s].run())
            reg_s = await wire_until(
                "agents registered",
                lambda: all(reg.is_connected(s) for s in slugs), tag="agent")
            await wire_until("heartbeats",
                             lambda: heartbeats.value() - hb0 >= agents,
                             tag="agent")
            row = dict(rpc=f"agent.register x{agents}",
                       wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                       registered_ms=round(reg_s * 1e3, 3),
                       heartbeats=heartbeats.value() - hb0, card=card)
            print(f"[agent] {json.dumps(row)}", flush=True)
            rpc.rows.append(row)

            stopped: set = set()

            def held(key: str) -> list:
                """Live agents holding other than their slice's count."""
                want: dict = {}
                for node in svc.retained(key)[1].assignment.values():
                    want[node] = want.get(node, 0) + 1
                return [s for s in slugs if s not in stopped
                        and len(fleet[s].backend.containers) != want.get(s, 0)]

            # the stage, placed on the card and fanned out to its agents
            flow = make_flow(services, 1, slugs, WIRE_FLOW_SEED)
            key = f"{flow.name}/app0"
            req = DeployRequest(flow=flow, stage_name="app0")
            t0 = time.perf_counter()
            dep, solves = await rpc(
                cli, f"deploy.execute {key}", "deploy", "execute",
                {"request": req.to_dict()}, want=expect, agents=agents)
            out["deploy_s"] = time.perf_counter() - t0
            if dep["deployment"]["status"] != "succeeded":
                raise AssertionError(f"[agent] deploy: {dep['deployment']}")
            dead: set = set()
            check(svc, dead, solves, f"deploy.execute {key}")
            bad = wire_misplaced(container_name, svc, fleet, key)
            extra = held(key)
            if bad or extra:
                raise AssertionError(f"[agent] deployed rows not running: "
                                     f"{bad[:5]}; agents off their slice "
                                     f"{extra[:5]}")

            # the heal: the busiest agent stops
            counts: dict = {}
            for node in dep["deployment"]["placement"].values():
                counts[node] = counts.get(node, 0) + 1
            gone = max(sorted(counts), key=counts.get)
            rc = handle.state.reconverger
            meter.take()
            seen = dict(_ext.LAUNCHES)
            fleet[gone].stop()
            stopped.add(gone)
            await asyncio.wait_for(tasks[gone], 30)

            def healed() -> bool:
                entry = svc.retained(key)
                return (entry is not None
                        and gone not in entry[1].assignment.values()
                        and rc.debt() == 0 and not rc.parked_stage_keys()
                        and not wire_misplaced(container_name, svc, fleet,
                                                key))
            heal_s = await wire_until("heal", healed, tag="agent")
            solves = meter.take()
            launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                        if v != seen[k]}
            dead.add(gone)
            heals = [d for d in handle.state.store.list("deployments")
                     if d.log.startswith("self-heal")]
            row = dict(rpc=f"heal {gone}", heal_s=round(heal_s, 3),
                       rows_moved=counts[gone], solves=len(solves),
                       solve_ms=round(sum(s[2] for s in solves), 3),
                       heal_records=len(heals), launches=launched,
                       card=card)
            print(f"[agent] {json.dumps(row)}", flush=True)
            rpc.rows.append(row)
            if not heals or held(key):
                raise AssertionError(f"[agent] heal: {len(heals)} records, "
                                     f"agents off their slice {held(key)}")
            if expect:
                cp_expect_launches(row["rpc"], launched, CP_WARM,
                                   any_of=True, tag="agent")
            check(svc, dead, solves, row["rpc"])
            out["heal_s"] = heal_s

            # the quadlet and the compose backends, onto one agent each
            live = [s for s in slugs if s != gone]
            for kind, target in ((Backend.QUADLET, live[0]),
                                 (Backend.COMPOSE, live[1])):
                side = make_flow(AGENT_SIDE_SERVICES, 1, [target],
                                 WIRE_FLOW_SEED)
                side.name = f"{kind.value}fleet"
                side.stages["app0"].backend = kind
                skey = f"{side.name}/app0"
                n_calls = len(systemctl.calls), len(compose.calls)
                dep, solves = await rpc(
                    cli, f"deploy.execute {skey}", "deploy", "execute",
                    {"request": DeployRequest(
                        flow=side, stage_name="app0").to_dict()})
                if dep["deployment"]["status"] != "succeeded":
                    raise AssertionError(f"[agent] {skey}: "
                                         f"{dep['deployment']}")
                check(svc, dead, solves, f"deploy.execute {skey}")
                stage = side.stages["app0"]
                if kind is Backend.QUADLET:
                    unit_dir = os.path.join(root, "units", target)
                    written = {}
                    for name in sorted(os.listdir(unit_dir)):
                        with open(os.path.join(unit_dir, name)) as f:
                            written[name] = f.read()
                    calls = systemctl.calls[n_calls[0]:]
                    ok = (written == build_stage_units(side, stage)
                          and ["daemon-reload"] in calls)
                    what = dict(units=len(written), systemctl=len(calls))
                else:
                    path = os.path.join(root, "deploys", target, side.name,
                                        "app0", ".fleetflow",
                                        "compose.app0.yaml")
                    with open(path) as f:
                        text = f.read()
                    calls = compose.calls[n_calls[1]:]
                    ok = (text == generate_compose_yaml(side, stage)
                          and calls and calls[0][-3:]
                          == ["up", "-d", "--remove-orphans"])
                    what = dict(compose_bytes=len(text), runs=len(calls))
                print(f"[agent] {json.dumps(dict(backend=kind.value, agent=target, equal=bool(ok), **what, card=card))}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"[agent] {kind.value} stage on "
                                         f"{target}: not what the "
                                         f"generator writes ({what})")

            # status and restart answer
            target = live[2]
            cname = sorted(fleet[target].backend.containers)[0]
            got, _ = await rpc(cli, f"container.restart {cname}",
                               "container", "restart",
                               {"server": target, "container": cname})
            pong, _ = await rpc(cli, f"server.ping {target}", "server",
                                "ping", {"slug": target})
            status = await reg.send_command(target, "status", {},
                                            timeout=30.0)
            names = {c["name"] for c in status["containers"]}
            if (got["result"].get("restarted") != cname or not pong["ok"]
                    or cname not in names):
                raise AssertionError(f"[agent] restart {got}, ping {pong}, "
                                     f"status {sorted(names)[:3]}")
            out["errors_before_stop"] = wire_errors(REGISTRY)
        finally:
            for s, agent in fleet.items():
                agent.stop()
            for t in tasks.values():
                try:
                    await asyncio.wait_for(t, 30)
                except BaseException:
                    t.cancel()
            await cli.close()
            cli_task.cancel()
            await handle.stop()
        return out

    try:
        out = asyncio.run(drive())
    finally:
        meter.close()
        set_engine(engine0)
    torch.cuda.synchronize()
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    err1 = wire_errors(REGISTRY)
    moved = fallbacks.value() - fb0
    cmd_moved = counter_total(cmd_errors) - cmd0
    errors = {ch: err1[ch] - err0[ch] for ch in WIRE_CHANNELS
              if err1[ch] != err0[ch]}
    took = time.perf_counter() - t_phase
    print(f"[agent] {json.dumps(dict(errors=errors, command_errors=cmd_moved, fallbacks=moved, memory_before=mem0, memory_after=mem_after, slack=WORLD_MEMORY_SLACK, card=card))}",
          flush=True)
    problems = []
    if errors:
        problems.append(f"request errors by channel {errors}")
    if cmd_moved:
        problems.append(f"{cmd_moved} agent command errors")
    if moved:
        problems.append(f"{moved} churn fallbacks")
    if abs(mem_after - mem0) > WORLD_MEMORY_SLACK:
        problems.append(f"allocated memory {mem0} -> {mem_after}")
    if problems:
        raise AssertionError("[agent] " + "; ".join(problems))
    launches = read_launches(torch, _ext, "agent", expect,
                             off=("k6_greedy_scan",))
    if expect:
        cp_expect_launches("agent", launches, CP_WARM, any_of=True,
                           tag="agent")
    summary = dict(phase_s=round(took, 3), budget_s=AGENT_BUDGET_S,
                   over_budget=took > AGENT_BUDGET_S,
                   deploy_s=round(out["deploy_s"], 3),
                   heal_s=round(out["heal_s"], 3), agents=agents,
                   rpcs=len(rpc.rows), launches=launches, card=card)
    print(f"[agent] {json.dumps(summary)}", flush=True)
    return summary


# [cli]: the operator's entry points, each reaching the card
CLI_BUDGET_S = 120.0       # the phase's time on the card's host
CLI_DIR = os.path.join("fleetflow_tpu_torch", "_ext_build", "cli")
# the chaos scenarios' docstring sizing (chaos/scenarios.py)
CLI_CHAOS = dict(services=60, nodes=10, stages=2)
# the daemon's health sweep: the servers registered here run no agent and
# send no heartbeat, so a sweep would read them offline
CLI_HEALTH_S = 3600
CLI_SOLVED = re.compile(r"^solved (\d+) services x (\d+) nodes via (\S+) in "
                        r"([\d.]+)ms \(feasible=(\w+), violations=(\d+)\)$")


def cli_run(cli_main, argv: list) -> tuple:
    """`fleet argv` through the port's ``cli.main.main`` in this process:
    (rc, stdout, stderr, wall ms)."""
    import io
    from contextlib import redirect_stderr, redirect_stdout
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli_main.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue(), \
        (time.perf_counter() - t0) * 1e3


def cli_proc(module: str, argv: list, env: dict, stdin: str = "",
             timeout: float = 300.0) -> tuple:
    """`python -m module argv` as a child process: (rc, stdout, stderr,
    wall ms)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module,
                          *[str(a) for a in argv]], input=stdin,
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    return out.returncode, out.stdout, out.stderr, \
        (time.perf_counter() - t0) * 1e3


def child_launches(directory: str, pid: Optional[int] = None) -> dict:
    """The launch counts the port's processes wrote into `directory` at
    their exit (``FLEET_LAUNCH_DIR``), summed (only `pid`'s when given)."""
    total = {k: 0 for k in KERNEL_NAMES}
    for name in sorted(os.listdir(directory)) if os.path.isdir(directory) \
            else []:
        if not (name.startswith("launches-") and name.endswith(".json")):
            continue
        with open(os.path.join(directory, name)) as f:
            doc = json.load(f)
        if pid is None or doc["pid"] == pid:
            for k in KERNEL_NAMES:
                total[k] += doc["launches"].get(k, 0)
    return total


def cli_solved(tag: str, line: str, want_source: str) -> dict:
    """A `fleet solve` head line: the card's source, feasible, 0
    violations."""
    m = CLI_SOLVED.match(line.strip())
    if not m or m.group(3) != want_source or m.group(5) != "True" \
            or m.group(6) != "0":
        raise AssertionError(f"[cli] {tag}: {line!r}")
    return dict(rows=int(m.group(1)), nodes=int(m.group(2)),
                solve_ms=float(m.group(4)))


def cli_check_assignment(np, verify, pt, assignment: dict, tag: str,
                         dead: set = frozenset()) -> None:
    """A printed assignment: every row of the stage on a live node of it,
    0 violations by the host verify."""
    if sorted(assignment) != sorted(pt.service_names):
        raise AssertionError(f"[cli] {tag}: the assignment names "
                             f"{len(assignment)} rows, the stage "
                             f"{len(pt.service_names)}")
    idx = {n: i for i, n in enumerate(pt.node_names)}
    raw = np.array([idx[assignment[s]] for s in pt.service_names])
    host = verify(pt, raw)
    on_dead = sorted(set(assignment.values()) & set(dead))
    if host["total"] or on_dead:
        raise AssertionError(f"[cli] {tag}: host verify {host}, on dead "
                             f"nodes {on_dead[:5]}")


def cli_metric(text: str, name: str, **labels) -> float:
    """A family's samples in a Prometheus exposition, summed over the label
    sets that hold `labels`."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name + "{") and \
                not line.startswith(name + " "):
            continue
        head, value = line.rsplit(" ", 1)
        have = dict(re.findall(r'(\w+)="([^"]*)"', head))
        if all(have.get(k) == str(v) for k, v in labels.items()):
            total += float(value)
    return total


def cli_tally(child: dict, counts: dict, size: tuple) -> None:
    """Add a child process's launches to the phase and to the tally of
    the fleet size it solved."""
    tally = BY_SIZE.setdefault(size_label(*size), {})
    for k in KERNEL_NAMES:
        child[k] += counts[k]
        tally[k] = tally.get(k, 0) + counts[k]


def run_cli_phase(torch, np, _ext, REGISTRY, verify, dev_name, card,
                  device=None, fleet=FRONTEND_FLEET,
                  servers=FRONTEND_SERVERS, shape=FRONTEND_SHAPE,
                  registry=None, registry_shape=(10_619, 1_000),
                  chaos=CLI_CHAOS, root=CLI_DIR) -> dict:
    """[cli]: the operator's entry points, each placing on the card.

    1. ``fleet --project-root D solve -s prod --json`` on [frontend]'s
       fleet written as a project (10,602 x 1,000), through the port's
       ``cli.main.main`` in this process and again as ``python -m
       fleetflow_tpu_torch.cli``; the printed assignment re-lowered and
       held by the host verify.
    2. ``python -m fleetflow_tpu_torch.daemon start`` (token auth, web and
       self-heal on, no ``solver-device``: the card); ``fleet cp login
       --secret``, ``fleet cp registry sync`` (the 1,000 servers), the
       servers marked up and the fleet placed through ``CpClient``
       (``placement.solve`` + ``commit``), the busiest node down (a churn
       re-solve); ``fleet cp placement state`` and ``explain``; ``GET
       /metrics`` before and after (``fleet_solver_solves_total`` of the
       card's backend must rise); ``fleet cp daemon stop`` (SIGTERM), its
       pid file gone.
    3. ``fleet cp registry solve`` on [registry]'s 8-fleet registry
       (10,619 x 1,000), with the daemon up.
    4. ``python -m fleetflow_tpu_torch.cli --project-root D mcp`` over
       stdio: ``initialize``, ``tools/list``, ``tools/call fleet_solve``.
    5. ``fleet chaos run rolling-kill-selfheal --seed 7`` at its docstring
       sizing with ``--record-trace``; ``fleet chaos run diurnal-hotspot``
       recording the traffic the plan loop replays (a trace of
       rolling-kill-selfheal carries no arrivals: a proposal replayed
       against it is never placed, in the reference too), and ``fleet plan
       simulate`` of ``examples/plan-simulate/flow.kdl`` against it.

    The child processes write their launch counts at exit
    (``FLEET_LAUNCH_DIR``); this process's solves are metered on
    ``GpuSolverScheduler.place``. Fails on a nonzero exit, a source other
    than ``gpu-anneal``, a violation, a row on a dead node, a solve off
    `dev_name`, a step without K4, K3 and K1 (and the daemon's churn
    without K2 or K5), a daemon that does not stop or leaves its pid
    file. Prints each step's wall ms (beside the solver's ms where the
    output carries it) and the phase's launches by kernel and seconds
    against its budget. Returns the phase's launch counts."""
    import shutil
    import signal
    import socket
    import urllib.request

    from fleetflow_tpu_torch.cli.client import CpClient
    from fleetflow_tpu_torch.core.loader import \
        load_project_from_root_with_stage
    from fleetflow_tpu_torch.core.parser import parse_kdl_string
    from fleetflow_tpu_torch.core.serialize import flow_to_dict
    from fleetflow_tpu_torch.cp.auth import TokenAuth
    from fleetflow_tpu_torch.lower import fleetgen
    from fleetflow_tpu_torch.lower.tensors import lower_stage
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
    # the module (the package's `main` attribute is the function)
    cli_main = importlib.import_module("fleetflow_tpu_torch.cli.main")
    registry = registry or dict(services=REGISTRY_SERVICES,
                                nodes=REGISTRY_NODES, fleets=REGISTRY_FLEETS)
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    proj = os.path.join(root, "project")
    os.makedirs(os.path.join(proj, ".fleetflow"))
    fleet_text = fleetgen.generate_fleet_kdl(
        fleet["fleet"], fleet["n_services"], seed=fleet["seed"],
        n_nodes_hint=fleet["n_nodes_hint"], port_base=fleet["port_base"])
    for fname, text in (("cloud.kdl", fleetgen.generate_servers_kdl(
            servers["n"], seed=servers["seed"])), ("fleet.kdl", fleet_text)):
        with open(os.path.join(proj, ".fleetflow", fname), "w") as f:
            f.write(text)
    reg_root = os.path.join(root, "registry")
    registry_write(fleetgen, reg_root, registry["services"],
                   registry["nodes"], fleets=registry["fleets"])
    home = os.path.join(root, "home")
    os.makedirs(home)
    launch_root = os.path.join(root, "launches")
    dev_args = [] if device is None else ["--device", str(device)]
    backend = "gpu" if device is None else "cpu"
    pt = lower_stage(load_project_from_root_with_stage(proj, "prod"), "prod")
    if shape is not None and (pt.S, pt.N) != tuple(shape):
        raise AssertionError(f"[cli] the project lowers to {pt.S}x{pt.N}")
    child = {k: 0 for k in KERNEL_NAMES}
    rows: list = []

    def env_for(step: str) -> dict:
        env = dict(os.environ, HOME=home, FLEET_CP_CA="",
                   FLEET_LAUNCH_DIR=os.path.join(launch_root, step),
                   PYTHONPATH=os.pathsep.join(
                       [repo] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        return env

    def row(step: str, **fields) -> dict:
        r = dict(step=step, **fields, card=card)
        print(f"[cli] {json.dumps(r)}", flush=True)
        rows.append(r)
        return r

    def solves_on_card(step: str, solves: list, at_least: int = 1):
        if len(solves) < at_least:
            raise AssertionError(f"[cli] {step}: {len(solves)} solves "
                                 f"on the card scheduler")
        for S, N, _ms, res in solves:
            if res.device != dev_name or res.violations:
                raise AssertionError(f"[cli] {step}: {S}x{N} solved on "
                                     f"{res.device}, {res.violations} "
                                     f"violations")

    def in_proc(step: str, argv: list, want=None):
        meter.take()
        seen = dict(_ext.LAUNCHES)
        rc, out, err, ms = cli_run(cli_main, argv)
        torch.cuda.synchronize()
        launched = {k: v - seen[k] for k, v in _ext.LAUNCHES.items()
                    if v != seen[k]}
        if rc != 0:
            raise AssertionError(f"[cli] {step}: exit {rc}: {out[-2000:]}"
                                 f"{err[-2000:]}")
        solves = meter.take()
        if want:
            cp_expect_launches(step, launched, want, tag="cli")
            solves_on_card(step, solves)
        return out, ms, solves, launched

    _ext.reset_launches()
    meter = WireMeter(_ext, GpuSolverScheduler)
    daemon_pid = None
    cfg = os.path.join(root, "fleetflowd.kdl")
    pid_file = os.path.join(root, "fleetflowd.pid")
    try:
        with env_set(HOME=home, FLEET_CP_CA="",
                     FLEET_REGISTRY=os.path.join(reg_root,
                                                 "fleet-registry.kdl")):
            # 1. fleet solve, in this process and as a child process
            argv = [*dev_args, "--project-root", proj, "solve", "-s", "prod",
                    "--json"]
            out, ms, solves, launched = in_proc("solve", argv, CP_COLD)
            head, body = out.split("\n", 1)
            got = cli_solved("solve", head, "gpu-anneal")
            cli_check_assignment(np, verify, pt, json.loads(body), "solve")
            row("fleet solve", wall_ms=round(ms, 3), **got,
                launches=launched)
            step_env = env_for("solve")
            rc, out, err, ms = cli_proc("fleetflow_tpu_torch.cli", argv,
                                        step_env)
            if rc != 0:
                raise AssertionError(f"[cli] python -m ...cli solve: exit "
                                     f"{rc}: {err[-2000:]}")
            head, body = out.split("\n", 1)
            got = cli_solved("python -m ...cli solve", head, "gpu-anneal")
            cli_check_assignment(np, verify, pt, json.loads(body),
                                 "python -m ...cli solve")
            counts = child_launches(step_env["FLEET_LAUNCH_DIR"])
            cp_expect_launches("python -m ...cli solve", counts, CP_COLD,
                               tag="cli")
            cli_tally(child, counts, (pt.S, pt.N))
            row("python -m fleetflow_tpu_torch.cli solve", wall_ms=round(
                ms, 3), **got, launches={k: v for k, v in counts.items()
                                         if v})

            # 2. the daemon
            ports = []
            for _ in range(2):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    ports.append(sock.getsockname()[1])
            cp_port, web_port = ports
            ep = f"127.0.0.1:{cp_port}"
            with open(cfg, "w") as f:
                f.write(f'pid-file "{pid_file}"\n'
                        f'log-file "{os.path.join(root, "fleetflowd.log")}"\n'
                        f'listen "127.0.0.1" {cp_port}\n'
                        f'web "127.0.0.1" {web_port}\n'
                        'db "memory"\ntls-dir ""\n'
                        f'auth "token" secret="{WIRE_SECRET}"\n'
                        'self-heal #true lease=4 grace=1 interval=0.5\n'
                        f'health-interval {CLI_HEALTH_S}\n'
                        + (f'solver-device "{device}"\n' if device else ""))
            daemon_env = env_for("daemon")
            rc, out, err, ms = cli_proc("fleetflow_tpu_torch.daemon",
                                        ["start", "-c", cfg], daemon_env)
            if rc != 0 or "started fleetflowd (pid" not in out:
                raise AssertionError(f"[cli] daemon start: exit {rc}: "
                                     f"{out}{err[-2000:]}")
            daemon_pid = int(out.split("pid ")[1].split(")")[0])
            row("fleetflowd start", wall_ms=round(ms, 3), pid=daemon_pid)
            out, ms, _, _ = in_proc("cp login", [
                "cp", "--cp", ep, "login", "--secret", WIRE_SECRET,
                "--email", "operator@chip-smoke"])
            row("fleet cp login", wall_ms=round(ms, 3))
            out, ms, _, _ = in_proc("cp registry sync", [
                "cp", "--cp", ep, "registry", "sync"])
            synced = out.count("synced ")
            if synced != registry["nodes"]:
                raise AssertionError(f"[cli] registry sync: {synced} "
                                     f"servers")
            row("fleet cp registry sync", wall_ms=round(ms, 3),
                servers=synced)
            token = TokenAuth(WIRE_SECRET).issue("scrape@chip-smoke",
                                                 ["read:health"])

            def scrape() -> str:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{web_port}/metrics")
                req.add_header("Authorization", f"Bearer {token}")
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.read().decode()
            solves0 = cli_metric(scrape(), "fleet_solver_solves_total",
                                 backend=backend)
            flow = parse_kdl_string(fleet_text, cache=False)
            key = f"{flow.name}/prod"
            with CpClient(ep) as cp:
                t0 = time.perf_counter()
                cp.request("placement", "node_events", {"events": [
                    {"slug": s, "online": True} for s in pt.node_names]},
                    timeout=600)
                row("placement.node_events up", wall_ms=round(
                    (time.perf_counter() - t0) * 1e3, 3), nodes=pt.N)
                t0 = time.perf_counter()
                rep = cp.request("placement", "solve", {
                    "flow": flow_to_dict(flow), "stage": "prod",
                    "reserve": True}, timeout=600)
                ms = (time.perf_counter() - t0) * 1e3
                if (not rep["feasible"] or rep["violations"]
                        or rep["source"] != "gpu-anneal"):
                    raise AssertionError(f"[cli] placement.solve: "
                                         f"{ {k: rep.get(k) for k in ('feasible', 'violations', 'source')} }")
                cli_check_assignment(np, verify, pt, rep["assignment"],
                                     "placement.solve")
                row("placement.solve", wall_ms=round(ms, 3),
                    reply_solve_ms=round(rep["solve_ms"], 3), rows=pt.S)
                ok = cp.request("placement", "commit",
                                {"reservation": rep["reservation"]})
                if not ok.get("ok"):
                    raise AssertionError(f"[cli] commit: {ok}")
                per: dict = {}
                for node in rep["assignment"].values():
                    per[node] = per.get(node, 0) + 1
                victim = max(sorted(per), key=per.get)
                t0 = time.perf_counter()
                moved = cp.request("placement", "node_events", {"events": [
                    {"slug": victim, "online": False}]}, timeout=600)
                ms = (time.perf_counter() - t0) * 1e3
                resched = moved["rescheduled"]
                if [m["stage"] for m in resched] != [key] or not all(
                        m["feasible"] for m in resched):
                    raise AssertionError(f"[cli] node_events: {moved}")
                row("placement.node_events busiest down",
                    wall_ms=round(ms, 3), node=victim,
                    rows_on_it=per[victim])
            out, ms, _, _ = in_proc("cp placement state", [
                "cp", "--cp", ep, "placement", "state"])
            row("fleet cp placement state", wall_ms=round(ms, 3),
                lines=len(out.splitlines()))
            name = next(n for n, node in sorted(rep["assignment"].items())
                        if node == victim)
            out, ms, _, _ = in_proc("cp placement explain", [
                "cp", "--cp", ep, "placement", "explain", "--stage", key,
                "--service", name])
            first = out.splitlines()[0] if out else ""
            if ("NOT FEASIBLE" in out or " -> " not in first
                    or first.split(" -> ")[1].split()[0] == victim):
                raise AssertionError(f"[cli] explain {name}: {out[:500]}")
            row("fleet cp placement explain", wall_ms=round(ms, 3),
                service=name, line=first)
            solves1 = cli_metric(scrape(), "fleet_solver_solves_total",
                                 backend=backend)
            if solves1 < solves0 + 2:
                raise AssertionError(f"[cli] the daemon's fleet_solver_"
                                     f"solves_total{{backend={backend}}} "
                                     f"{solves0} -> {solves1}")
            row("GET /metrics", solves_before=solves0, solves_after=solves1,
                backend=backend)

            # 3. fleet cp registry solve, the daemon up
            out, ms, solves, launched = in_proc("cp registry solve", [
                *dev_args, "cp", "--cp", ep, "registry", "solve"], CP_COLD)
            want = (f"aggregate: {registry_shape[0]} services x "
                    f"{registry_shape[1]} nodes feasible=True via "
                    f"gpu-anneal") if registry_shape else \
                "feasible=True via gpu-anneal"
            if want not in out:
                raise AssertionError(f"[cli] registry solve: {out!r}")
            row("fleet cp registry solve", wall_ms=round(ms, 3),
                line=out.strip(), solve_ms=round(sum(s[2] for s in solves),
                                                 3), launches=launched)

            # the daemon stops on SIGTERM and removes its pid file
            out, ms, _, _ = in_proc("cp daemon stop", [
                "cp", "daemon", "stop", "-c", cfg])
            t0 = time.perf_counter()
            while os.path.exists(pid_file) or not os.path.exists(
                    os.path.join(daemon_env["FLEET_LAUNCH_DIR"],
                                 f"launches-{daemon_pid}.json")):
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("[cli] the daemon did not stop "
                                         "within 60 s")
                time.sleep(0.05)
            daemon_pid = None
            row("fleet cp daemon stop", wall_ms=round(
                ms + (time.perf_counter() - t0) * 1e3, 3))
            counts = child_launches(daemon_env["FLEET_LAUNCH_DIR"])
            cp_expect_launches("fleetflowd", counts, CP_COLD, tag="cli")
            cp_expect_launches("fleetflowd churn", counts, CP_WARM,
                               any_of=True, tag="cli")
            cli_tally(child, counts, (pt.S, pt.N))
            row("fleetflowd launches", launches={k: v for k, v in
                                                 counts.items() if v})

            # 4. the MCP server over stdio
            msgs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                     "params": {}},
                    {"jsonrpc": "2.0", "method": "notifications/initialized"},
                    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                    {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                     "params": {"name": "fleet_solve",
                                "arguments": {"stage": "prod"}}}]
            step_env = env_for("mcp")
            rc, out, err, ms = cli_proc(
                "fleetflow_tpu_torch.cli",
                [*dev_args, "--project-root", proj, "mcp"], step_env,
                stdin="".join(json.dumps(m) + "\n" for m in msgs))
            replies = [json.loads(ln) for ln in out.splitlines()]
            if rc != 0 or [r.get("id") for r in replies] != [1, 2, 3]:
                raise AssertionError(f"[cli] mcp: exit {rc}: {out[:500]}"
                                     f"{err[-2000:]}")
            res = replies[2]["result"]
            doc = json.loads(res["content"][0]["text"])
            if res.get("isError") or doc.get("source") != "gpu-anneal" \
                    or doc.get("violations") or not doc.get("feasible"):
                raise AssertionError(f"[cli] mcp fleet_solve: "
                                     f"{str(res)[:500]}")
            cli_check_assignment(np, verify, pt, doc["assignment"],
                                 "mcp fleet_solve")
            counts = child_launches(step_env["FLEET_LAUNCH_DIR"])
            cp_expect_launches("mcp", counts, CP_COLD, tag="cli")
            cli_tally(child, counts, (pt.S, pt.N))
            row("mcp fleet_solve", wall_ms=round(ms, 3),
                solve_ms=doc["solve_ms"], tools=len(
                    replies[1]["result"]["tools"]),
                launches={k: v for k, v in counts.items() if v})

            # 5. chaos and the plan loop
            size = ["--seed", "7", "--services", chaos["services"],
                    "--nodes", chaos["nodes"], "--stages", chaos["stages"]]
            for scenario in ("rolling-kill-selfheal", "diurnal-hotspot"):
                trace = os.path.join(root, f"{scenario}.jsonl")
                out, ms, solves, launched = in_proc(
                    f"chaos run {scenario}",
                    [*dev_args, "chaos", "run", "--scenario", scenario,
                     *size, "--record-trace", trace], CP_COLD)
                if "all invariants hold" not in out:
                    raise AssertionError(f"[cli] chaos {scenario}: "
                                         f"{out[-1000:]}")
                digest = out.split("event-log digest ")[1].split()[0]
                row(f"fleet chaos run {scenario}", wall_ms=round(ms, 3),
                    solves=len(solves), solve_ms=round(sum(
                        s[2] for s in solves), 3), digest=digest,
                    launches=launched)
            flow_kdl = os.path.join(repo, "examples", "plan-simulate",
                                    "flow.kdl")
            out, ms, solves, launched = in_proc("plan simulate", [
                *dev_args, "plan", "simulate", flow_kdl, "--trace", trace],
                CP_COLD)
            if "proposal holds the recorded SLOs" not in out:
                raise AssertionError(f"[cli] plan simulate: {out[-1000:]}")
            row("fleet plan simulate", wall_ms=round(ms, 3),
                solves=len(solves), launches=launched,
                digest=out.split("report digest ")[1].split()[0])
    finally:
        meter.close()
        if daemon_pid is not None:
            try:
                os.kill(daemon_pid, signal.SIGTERM)
                t0 = time.perf_counter()
                while os.path.exists(pid_file) and \
                        time.perf_counter() - t0 < 30:
                    time.sleep(0.1)
                os.kill(daemon_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    launches = read_launches(torch, _ext, "cli", CP_COLD,
                             off=("k6_greedy_scan",))
    for k in KERNEL_NAMES:
        launches[k] += child[k]
    took = time.perf_counter() - t_phase
    summary = dict(phase_s=round(took, 3), budget_s=CLI_BUDGET_S,
                   over_budget=took > CLI_BUDGET_S, steps=len(rows),
                   launches_in_process={k: v - child[k]
                                        for k, v in launches.items()},
                   launches_children=child, launches=launches, card=card)
    print(f"[cli] {json.dumps(summary)}", flush=True)
    return summary


AUDIT_BUDGET_S = 45.0       # the phase's time on the card's host
# the kernels each audited dispatch launches (PERF.md, the kernel table):
# (always, and K1 when the warm anneal sweeps — a lane that is feasible
# after the fused pre-repair exits before its first sweep)
AUDIT_KERNELS = {
    "resident.merge": ((), ()), "sharded.merge": ((), ()),
    "refine.warm": (("k2_prerepair", "k3_rebuild"), ("k1_sweep",)),
    "mux.anneal": (("k2_prerepair", "k3_rebuild"), ("k1_sweep",)),
    "subsolve.localized": (("k2_prerepair", "k3_rebuild", "k5_subsolve"),
                           ("k1_sweep",)),
    "sharded.anneal": (("k3_rebuild", "k7_sharded_sweep"), ()),
}


def audit_fleets(lower, headline, mux_fleet):
    """The full-width audit's fleets as this run already made them (the
    generator's arguments matched exactly): the headline fleet, the
    sharded fleet and the mux leg's stages; any other is generated."""
    tenants = dict(seed=0, n_tenants=8, port_fraction=0.2,
                   volume_fraction=0.1)

    def make(S, N, kw):
        if kw == tenants and (S, N) == (N_SERVICES, N_NODES):
            return headline
        if kw == tenants and (S, N) == SHARDED_SHAPE:
            return sharded_fleet(lower, SHARDED_SHAPE)
        if set(kw) == {"seed", "port_fraction", "volume_fraction"} and \
                (kw["port_fraction"], kw["volume_fraction"]) == (0.3, 0.2):
            return mux_fleet(S, N, kw["seed"])
        return lower.synthetic_problem(S, N, **kw)
    return make


def run_audit_phase(torch, _ext, card, dev, fleet=None) -> dict:
    """[audit]: the launch contracts of the hot dispatches on the card
    (fleetflow_tpu_torch/analysis/auditor.py over solver/contracts.py).

    1. ``audit_kernels()`` at full width (resident.merge, refine.warm and
       subsolve.localized on the headline fleet staged at 10,848 x 1,000,
       mux.anneal at 8 lanes of 2,000 x 200, sharded.merge and
       sharded.anneal at SHARDED_SHAPE on a 1x8 mesh; `fleet` hands it
       the fleets this run already made).
    2. ``fleet audit all --strict --baseline <the port's ledger>`` through
       ``cli.main.main`` in this process (the card): exit 0. Its own
       ``audit_kernels()`` at AUDIT_TIERS (the pinned golden's cases) is
       read back through a spy, and its report must equal
       analysis/launch_contract.json.

    Both reports: every intrinsic check holds — the merges write their
    planes in place, the warm dispatches keep their seeds and make no
    upload in their profiler range, nothing is built at a later tier,
    every output is on the card — all six contracts are audited at every
    tier, and each dispatch launches its kernels (AUDIT_KERNELS) and no
    other. One line per dispatch and tier: the planes written in place,
    the uploads, downloads and syncs in its range, its CUDA-event ms, the
    kernels it launched and the card.

    Launches are tallied under "audit full" and "audit cli": each runs
    several fleets."""
    from fleetflow_tpu_torch.analysis import auditor
    from fleetflow_tpu_torch.analysis.baseline import default_baseline_path
    from fleetflow_tpu_torch.solver.contracts import (AUDIT_TIERS,
                                                      audit_scale,
                                                      hot_path_kernels)
    cli_main = importlib.import_module("fleetflow_tpu_torch.cli.main")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    _ext.reset_launches()
    with open(auditor.default_contract_path(), encoding="utf-8") as f:
        pinned = json.load(f)
    names = [c.name for c in hot_path_kernels()]

    since = dict(_ext.LAUNCHES)
    t0 = time.perf_counter()
    full = auditor.audit_kernels(device=dev,
                                 scale=audit_scale("full", fleet))
    full_s = time.perf_counter() - t0
    tally_label(_ext, "audit full", since)

    since = dict(_ext.LAUNCHES)
    reports: list = []
    real = auditor.audit_kernels

    def spy(*args, **kw):
        reports.append(real(*args, **kw))
        return reports[-1]

    auditor.audit_kernels = spy
    try:
        rc, out, err, cli_ms = cli_run(cli_main, [
            "audit", "all", "--strict", "--baseline",
            default_baseline_path()])
    finally:
        auditor.audit_kernels = real
    tally_label(_ext, "audit cli", since)
    if rc != 0 or "audit all clean" not in out or len(reports) != 1:
        raise AssertionError(f"[audit] fleet audit all --strict: rc {rc}, "
                             f"{len(reports)} audits: {out[-2000:]} "
                             f"{err[-2000:]}")
    tiers = reports[0]
    drift = auditor.contract_diff(tiers, pinned)
    if drift:
        raise AssertionError(f"[audit] drift from launch_contract.json: "
                             f"{drift}")

    rows = []
    for report, n_tiers in ((tiers, len(AUDIT_TIERS)), (full, 1)):
        scale = report["_scale"]
        if report.violations or report["_device"] != str(dev):
            raise AssertionError(f"[audit] {scale} on {report['_device']}: "
                                 f"{report.violations}")
        audited = {k: list(e["tiers"]) for k, e in report["kernels"].items()}
        if list(audited) != names or any(len(t) != n_tiers
                                         for t in audited.values()):
            raise AssertionError(f"[audit] {scale}: audited {audited}")
        for name, entry in report["kernels"].items():
            for tier, rec in entry["tiers"].items():
                t = rec["host_traffic"]
                always, maybe = AUDIT_KERNELS[name]
                if not set(always) <= set(rec["launches"]) \
                        <= set(always + maybe):
                    raise AssertionError(
                        f"[audit] {name}@{tier} launched {rec['launches']}, "
                        f"expected {always} and maybe {maybe}")
                row = dict(dispatch=name, tier=tier, scale=scale,
                           in_place=rec["in_place"], kept=rec["kept"],
                           h2d=len(t["h2d"]), d2h=len(t["d2h"]),
                           syncs=t["syncs"], device_ops=t["ops"],
                           ms=round(rec["ms"], 3), launches=rec["launches"],
                           builds=rec["builds"], card=card)
                rows.append(row)
                print(f"[audit] {json.dumps(row)}", flush=True)
    print(f"[audit] full width: {len(names)} dispatches in {full_s:.3f} s "
          f"({json.dumps(full['_seconds'])}); fleet audit all --strict: "
          f"rc 0 in {cli_ms:.1f} ms, its tiers' audit "
          f"{json.dumps(tiers['_seconds'])} equal to launch_contract.json; "
          f"{out.strip().splitlines()[-1]}; {err.strip()}", flush=True)
    launches = read_launches(
        torch, _ext, "audit",
        ("k1_sweep", "k2_prerepair", "k3_rebuild", "k4_greedy",
         "k5_subsolve", "k7_sharded_sweep"), off=("k6_greedy_scan",))
    took = time.perf_counter() - t_phase
    summary = dict(phase_s=round(took, 3), budget_s=AUDIT_BUDGET_S,
                   over_budget=took > AUDIT_BUDGET_S, cases=len(rows),
                   full_s=round(full_s, 3), cli_ms=round(cli_ms, 3),
                   launches=launches, card=card)
    print(f"[audit] {json.dumps(summary)}", flush=True)
    return summary

def launches_by_size(name: str, total: int) -> dict:
    """A kernel's main-path launches by the fleet size they ran at; every
    phase's launches must have been tallied."""
    out = {size: t[name] for size, t in BY_SIZE.items() if t.get(name)}
    if sum(out.values()) != total:
        raise AssertionError(f"{name}: {total} launches, {out} by size")
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    if sys.argv[1:2] == ["--ranks-worker"]:
        return ranks_worker(sys.argv[2])
    try:
        from fleetflow_tpu_torch import _ext
        from fleetflow_tpu_torch.entry import dryrun_multichip, entry
        from fleetflow_tpu_torch.lower import tensors as lower
        from fleetflow_tpu_torch.sched import (GpuSolverScheduler,
                                               pick_scheduler,
                                               place_with_fallback,
                                               relax_problem)
        from fleetflow_tpu_torch.solver import (anneal, api, buckets, greedy,
                                                kernels, multiplex, problem,
                                                sharded, sharded_ranks,
                                                subsolve)
        from fleetflow_tpu_torch.solver.api import solve
        from fleetflow_tpu_torch.solver.repair import repair, verify
        from fleetflow_tpu_torch.solver.resident import (ProblemDelta,
                                                         ResidentProblem)
        from fleetflow_tpu_torch import core
        from fleetflow_tpu_torch.core import parsecache, serialize
        from fleetflow_tpu_torch.lower import fleetgen
        from fleetflow_tpu_torch.native import kdl as native_kdl
        from fleetflow_tpu_torch.solver.explain import explain_assignment
        from fleetflow_tpu_torch.cp import models as cp_models
        from fleetflow_tpu_torch.cp import placement as cp_placement
        from fleetflow_tpu_torch.cp.admission import (AdmissionConfig,
                                                      AdmissionController)
        from fleetflow_tpu_torch.cp.store import Store
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
    except ImportError as e:
        return fail(f"fleetflow_tpu_torch is not importable here ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"[card] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    # the host libraries (g++: the placer, the KDL parser and its CPython
    # assembly) build into their own directory beside the kernels' nvcc
    # builds, all at once
    inc = sysconfig.get_paths().get("include") or ""
    print(f"[build] Python.h in {inc}: "
          f"{os.path.isfile(os.path.join(inc, 'Python.h'))}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: ([_ext.host_library(n)
                                     for n in _ext.HOST_LIBS],
                                    [_ext.host_extension(n)
                                     for n in _ext.HOST_EXTS]))
        build_s = _ext.build(verbose=True)
        host.result()
    print(f"[build] {len(_ext.KERNELS)} kernels built in {build_s:.1f} s, "
          f"{len(_ext.HOST_LIBS)} host libraries and "
          f"{len(_ext.HOST_EXTS)} extension with them", flush=True)

    recs = check_kernels(torch, np, (anneal, kernels, greedy, problem, lower,
                                     buckets), dev)
    recs["k6_greedy_scan"] = check_k6(torch, np, (greedy, problem, lower),
                                      dev)
    recs["k7_sharded_sweep"] = check_k7(
        torch, np, (sharded, problem, buckets, greedy, anneal), lower, dev)
    fleet = mux_fleets(lower)
    tenant_fleet = default_fleet(np, lower)[0]
    lane_pkg = (anneal, kernels, greedy, problem, lower, buckets)
    check_lane_kernels(torch, np, lane_pkg, dev, recs, "lanes",
                       [fleet(*MUX_TIERS[1], i) for i in range(8)])
    check_lane_kernels(torch, np, lane_pkg, dev, recs, "lanes",
                       [tenant_fleet, tenant_fleet])
    check_k2_tiers(torch, np, lane_pkg, dev, recs)
    measure_rows(torch, np, (anneal, greedy, problem, lower, buckets), dev,
                 recs)
    small_agreement(torch, lower, solve)
    pkg_main = (GpuSolverScheduler, ProblemDelta, verify, _ext, subsolve)
    pt = lower.synthetic_problem(N_SERVICES, N_NODES, seed=0, n_tenants=8,
                                 port_fraction=0.2, volume_fraction=0.1)
    by_phase = {"main": run_main_path(torch, np, pkg_main, pt, str(dev))}
    by_phase["default"], recs["k5_subsolve"], masks = run_default_phase(
        torch, np, pkg_main, lower, str(dev))
    _totals, full_zero_ms = compare_subsolve(np, pkg_main, lower, str(dev),
                                             masks)
    by_phase["obs"] = run_obs_phase(
        torch, np, (_ext, GpuSolverScheduler, ProblemDelta, verify, solve,
                    ResidentProblem, multiplex, sharded, api),
        lower, dev, fleet, full_zero_ms, card)
    by_phase["mux"], _mux_rows = run_mux_phase(
        torch, np, (_ext, solve, ResidentProblem, ProblemDelta, multiplex),
        fleet, str(dev), tenant_fleet)
    by_phase["slots"] = run_slots_phase(
        torch, np, (_ext, GpuSolverScheduler, ProblemDelta, verify), fleet,
        str(dev))
    by_phase["seeds"] = run_seeds_phase(
        torch, np, (_ext, solve, verify, ResidentProblem, ProblemDelta), pt,
        str(dev))
    by_phase["fallback"] = run_fallback_phase(
        torch, np, (_ext, GpuSolverScheduler, place_with_fallback,
                    relax_problem, pick_scheduler, verify), lower, str(dev))
    by_phase["frontend"], fe_flow, fe_pool = run_frontend_phase(
        torch, np, (_ext, GpuSolverScheduler, ProblemDelta, verify, solve,
                    place_with_fallback, relax_problem, core, serialize,
                    fleetgen, lower, native_kdl, parsecache,
                    explain_assignment), str(dev))
    # [options]: overlap_host_work re-lowering [frontend]'s flow, the
    # sharded width, do_repair=False
    by_phase["options"] = run_options_phase(
        torch, np, (_ext, GpuSolverScheduler, ProblemDelta, verify, solve,
                    repair, ResidentProblem, multiplex, sharded), lower, dev,
        fe_flow, fe_pool, card)
    by_phase["cp"] = run_cp_phase(
        torch, np, (_ext, cp_models, Store, cp_placement,
                    AdmissionController, AdmissionConfig, REGISTRY, verify,
                    fleetgen, core), str(dev), fe_flow, fe_pool, card)
    by_phase["entry"] = run_entry_phase(
        torch, (_ext, entry, kernels.total_cost, problem), lower, dev)
    by_phase["sharded"], k7_layouts = run_sharded_phase(
        torch, np, (_ext, sharded, anneal, kernels, verify, ProblemDelta),
        lower, dev, recs)
    k7 = recs["k7_sharded_sweep"]
    k7["layouts"].update({k: {f: v[f] for f in LAYOUT_KEYS}
                          for k, v in k7_layouts.items()})
    k7["max_abs_err"] = max(v["max_abs_err"] for v in k7["layouts"].values())
    by_phase["dryrun"] = run_dryrun_phase(torch, _ext, dryrun_multichip)
    # [ranks]: 4 ranks of a gloo group on the card (the sharded anneal and
    # solve across ranks, the chain mesh); their launches come back
    # through FLEET_LAUNCH_DIR
    by_phase["ranks"] = run_ranks_phase(
        torch, np, (_ext, sharded, sharded_ranks, problem, buckets, greedy,
                    anneal, solve, GpuSolverScheduler, verify, ProblemDelta),
        lower, dev, card, pt, recs)
    # [heal] drives the main path last: ~3 minutes of host work and ~10 GB
    # of request payloads before [sharded] left its torch.profiler traces
    # without the device records that reach back before the dispatch
    by_phase["heal"] = run_heal_phase(
        torch, np, (_ext, cp_models, Store, cp_placement, REGISTRY, verify,
                    fleetgen, core), str(dev), fe_flow, fe_pool, card)
    # [world]: every scenario of the chaos pack and the acceptance runs,
    # each world placing on the card
    by_phase["world"] = run_world_phase(torch, _ext, REGISTRY, card)
    # [wire]: a control-plane server on a socket, its agents, a heal and
    # a standby's promotion, every placement on the card; the [frontend]
    # fleet parsed again ([cp]'s admission stream grew fe_flow in place)
    wire_flow = core.parse_kdl_string(fleetgen.generate_fleet_kdl(
        FRONTEND_FLEET["fleet"], FRONTEND_FLEET["n_services"],
        seed=FRONTEND_FLEET["seed"],
        n_nodes_hint=FRONTEND_FLEET["n_nodes_hint"],
        port_base=FRONTEND_FLEET["port_base"]), cache=False)
    by_phase["wire"] = run_wire_phase(torch, np, _ext, REGISTRY, verify,
                                      str(dev), wire_flow, fe_pool, card)
    # [registry]: BASELINE config 4's 8-fleet instance aggregated from a
    # registry and placed on the card, then a one-fleet edit re-placed warm
    by_phase["registry"] = run_registry_phase(torch, np, _ext, REGISTRY,
                                              str(dev), card)["launches"]
    # [agent]: real port agents behind a control-plane server placing on
    # the card: a deploy, a heal, the quadlet and compose backends
    by_phase["agent"] = run_agent_phase(torch, np, _ext, REGISTRY, verify,
                                        str(dev), card)["launches"]
    # [cli]: the operator's entry points (fleet solve in this process and
    # as a child, the daemon, registry solve, MCP, chaos and the plan loop)
    by_phase["cli"] = run_cli_phase(torch, np, _ext, REGISTRY, verify,
                                    str(dev), card)["launches"]
    # [audit]: the launch contracts of the six hot dispatches on the card
    # (in place, kept seeds, no upload, no build at a later tier) and
    # `fleet audit all --strict` in this process
    by_phase["audit"] = run_audit_phase(
        torch, _ext, card, dev, audit_fleets(lower, pt, fleet))["launches"]
    measure_device(recs)
    measure_k7_device(recs)
    measure_k5_device(recs)
    measure_phases(recs)
    measure_k67_phases(recs)
    if "--profile" in sys.argv[1:]:
        profile_phases(torch, np, pkg_main, lower, pt)
        profile_mux(torch, (_ext, solve, ResidentProblem, ProblemDelta,
                            multiplex), fleet, str(dev))
    out = []
    for name in KERNEL_NAMES:
        r = recs[name]
        t_bytes = r.pop("bytes") / PEAK_BYTES_S * 1e3
        t_ops = r.pop("ops") / PEAK_OPS_S * 1e3
        r["launches"] = sum(counts[name] for counts in by_phase.values())
        r["launches_by_phase"] = {p: c[name] for p, c in by_phase.items()}
        r["launches_by_size"] = launches_by_size(name, r["launches"])
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_phase", "launches_by_size", "max_abs_err", "ms",
            "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_ms", "device_launches",
            "sizes", "device", "lanes", "phases", "small_ms", "us_per_step",
            "strict", "layouts", "entries", "uploads", "device_tier")
            if k in r})
    print(f"[done] {time.perf_counter() - t0:.1f} s after the build started",
          flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
