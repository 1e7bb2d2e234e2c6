"""Fleet-scale KDL generators for end-to-end pipeline benchmarks (the
port's copy of ``fleetflow_tpu/lower/fleetgen.py``: the same seed gives the
same text).

The reference pays discovery + templating + KDL parse + conversion on every
deploy (fleetflow-core loader.rs:25-74) before its engine loop ever runs a
container. These generators produce the INPUT side of that
pipeline: real KDL text for a multi-tenant fleet registry, shaped like
lower.synthetic_problem's instances (dependency chains, shared host ports,
exclusive volumes) so the resulting solve is comparable to the headline
10k x 1k numbers.

The pipeline under test is then exactly production's:

    KDL text --parse_kdl_string--> Flow    (native kdl.cpp fast path)
        --lower_stage--> ProblemTensors    (one fleet; a registry of
                                            fleets aggregates first)
        --prepare_problem--> DeviceProblem     (device staging)
        --solve--> assignment

Feasibility by construction: server capacity is sized ~3x the mean
per-node demand, port/volume pools cap conflict-group sizes well under the
node count, and all services are eligible everywhere (the aggregate stage
carries no placement policy).
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_fleet_kdl", "generate_servers_kdl"]


def generate_fleet_kdl(fleet: str, n_services: int, *, seed: int = 0,
                       port_fraction: float = 0.2,
                       volume_fraction: float = 0.1,
                       dep_depth_max: int = 5,
                       n_nodes_hint: int = 1000,
                       port_base: int = 10000,
                       replica_fraction: float = 0.05,
                       coloc_fraction: float = 0.05) -> str:
    """KDL text for one tenant fleet: top-level service nodes plus a
    `stage "prod"` listing them.

    Structure mirrors lower.synthetic_problem (shared demand ranges from
    tensors.SYNTH_*): services form dependency chains of depth <=
    dep_depth_max; `port_fraction` of services publish a host port drawn
    from a pool sized so ~4 services share each port (mutual
    anti-affinity); `volume_fraction` claim an exclusive host volume from a
    pool with ~3 claimants each.  Group sizes stay far below
    `n_nodes_hint` so instances survive churn events.

    `port_base` must give each fleet in a registry a DISJOINT port range:
    conflict identity is (ip, port, proto), so aggregation merges
    same-numbered ports across fleets, and a merged group can exceed the
    per-fleet membership cap (up to fleets x cap services on one port) —
    past n_nodes it would be infeasible by construction.  Volumes are safe
    without this: their conflict key is the host path, which embeds the
    fleet name.
    """
    from .tensors import SYNTH_CPU_RANGE, SYNTH_DISK_RANGE, SYNTH_MEM_RANGE

    rng = np.random.default_rng(seed)
    names = [f"{fleet}-svc-{i:05d}" for i in range(n_services)]

    n_ports = max(int(n_services * port_fraction / 4), 1)
    port_members = np.zeros(n_ports, dtype=np.int64)
    n_vols = max(int(n_services * volume_fraction / 3), 1)

    # dependency chains over a shuffled order, like synthetic_problem
    dep_of: dict[int, int] = {}
    order = rng.permutation(n_services)
    i = 0
    while i < len(order):
        chain_len = int(rng.integers(1, dep_depth_max + 1))
        chain = order[i:i + chain_len]
        for a, b in zip(chain[1:], chain[:-1]):
            dep_of[int(a)] = int(b)
        i += chain_len

    lines: list[str] = [f'project "{fleet}"', ""]
    for s, name in enumerate(names):
        cpu = rng.uniform(*SYNTH_CPU_RANGE)
        mem = rng.uniform(*SYNTH_MEM_RANGE)
        disk = rng.uniform(*SYNTH_DISK_RANGE)
        lines.append(f'service "{name}" {{')
        lines.append(f'    image "registry.example/{fleet}/app:1.0"')
        lines.append('    resources {')
        lines.append(f'        cpu {cpu:.3f}')
        lines.append(f'        memory {mem:.1f}')
        lines.append(f'        disk {disk:.1f}')
        lines.append('    }')
        if s in dep_of:
            lines.append(f'    depends_on "{names[dep_of[s]]}"')
        has_port = False
        if rng.random() < port_fraction:
            open_ids = np.flatnonzero(port_members < n_nodes_hint - 1)
            if open_ids.size:          # pool exhausted: skip, stay feasible
                p = int(open_ids[int(rng.integers(0, open_ids.size))])
                port_members[p] += 1
                lines.append(f'    port host={port_base + p} container=8080')
                has_port = True
        if rng.random() < volume_fraction:
            v = int(rng.integers(0, n_vols))
            lines.append(
                f'    volume "/data/{fleet}/vol-{v:04d}" "/var/data"')
        # replica expansion + colocation exercise the remaining constraint
        # classes at pipeline scale (the solve must handle every KDL
        # construct the config layer accepts, not just ports/volumes).
        # Port-publishing services stay replicas=1 — identical host ports
        # on every replica would be infeasible by construction — and
        # colocation targets the service's dependency (the natural
        # "run next to what I call" shape).
        if not has_port and rng.random() < replica_fraction:
            lines.append(f'    replicas {int(rng.integers(2, 4))}')
        if s in dep_of and rng.random() < coloc_fraction:
            lines.append(f'    colocate_with "{names[dep_of[s]]}"')
        lines.append('}')
    lines.append("")
    lines.append('stage "prod" {')
    lines.append('    placement "spread_across_pool"')
    for name in names:
        lines.append(f'    service "{name}"')
    lines.append('}')
    return "\n".join(lines) + "\n"


def generate_servers_kdl(n_nodes: int, *, seed: int = 0,
                         cpu: float = 8.0, memory_mb: float = 8192.0,
                         disk_mb: float = 32768.0) -> str:
    """KDL text declaring the registry's shared server pool.

    Default capacity gives ~3x headroom over the mean per-node demand of a
    10k-service fleet on 1k nodes (mean service: 0.275 cpu / 272 MiB mem /
    512 MiB disk -> ~2.75 cpu / 2.7 GiB / 5.1 GiB per node at 10 services
    per node).
    """
    rng = np.random.default_rng(seed)
    lines: list[str] = []
    for j in range(n_nodes):
        jitter = rng.uniform(1.0, 1.25)
        lines.append(f'server "node-{j:04d}" {{')
        lines.append('    capacity {')
        lines.append(f'        cpu {cpu * jitter:.2f}')
        lines.append(f'        memory {memory_mb * jitter:.0f}')
        lines.append(f'        disk {disk_mb * jitter:.0f}')
        lines.append('    }')
        lines.append('}')
    return "\n".join(lines) + "\n"
