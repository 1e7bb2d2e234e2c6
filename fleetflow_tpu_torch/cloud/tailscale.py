"""Tailscale CLI wrapper (the port's copy of
``fleetflow_tpu/cloud/tailscale.py``).

Analog of fleetflow-cloud tailscale.rs:57-149: `tailscale status --json`
peer listing, `tailscale ping`, and peer-status resolution (online when the
peer is active or recently seen) — the reference CP's server health source
(fleetflowd health.rs:34-69). The runner is injectable; without the CLI,
`get_peers` reports unavailable instead of raising.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Peer", "get_peers", "ping", "resolve_peer_status", "available"]

RECENT_SEEN_S = 300.0


@dataclass
class Peer:
    hostname: str
    ip: Optional[str] = None
    online: bool = False
    last_seen: Optional[float] = None   # epoch seconds
    os: str = ""
    tags: list[str] = field(default_factory=list)


def available() -> bool:
    return shutil.which("tailscale") is not None


def _run(args: list[str], runner=None) -> tuple[int, str]:
    if runner is not None:
        return runner(args)
    proc = subprocess.run(["tailscale", *args], capture_output=True, text=True)
    return proc.returncode, proc.stdout


def get_peers(runner=None) -> list[Peer]:
    """tailscale.rs get_peers:57. The degraded paths (CLI missing, rc!=0,
    unparseable JSON) still answer [] — but counted and warned-once via
    fleet_cloud_provider_degraded_total so "no peers" from a broken
    tailscaled is visible as degradation, not an empty fleet."""
    from .provider import note_degraded
    if runner is None and not available():
        note_degraded("tailscale", "tailscale CLI not found")
        return []
    rc, out = _run(["status", "--json"], runner)
    if rc != 0:
        note_degraded("tailscale", f"status rc={rc}")
        return []
    try:
        doc = json.loads(out)
    except json.JSONDecodeError:
        note_degraded("tailscale", "unparseable status JSON")
        return []
    peers = []
    for peer in (doc.get("Peer") or {}).values():
        last_seen = None
        seen = peer.get("LastSeen")
        if seen and not str(seen).startswith("0001-"):
            try:
                import datetime
                last_seen = datetime.datetime.fromisoformat(
                    str(seen).replace("Z", "+00:00")).timestamp()
            except ValueError:
                pass
        ips = peer.get("TailscaleIPs") or []
        peers.append(Peer(
            hostname=str(peer.get("HostName", "")).lower(),
            ip=ips[0] if ips else None,
            online=bool(peer.get("Online")),
            last_seen=last_seen,
            os=peer.get("OS", ""),
            tags=peer.get("Tags") or []))
    return peers


def ping(host: str, runner=None) -> bool:
    """tailscale.rs ping."""
    rc, _ = _run(["ping", "--c", "1", "--timeout", "3s", host], runner)
    return rc == 0


def resolve_peer_status(peer: Peer, now: Optional[float] = None) -> str:
    """tailscale.rs resolve_peer_status:149: online if active, or seen
    within the recent window."""
    if peer.online:
        return "online"
    if peer.last_seen is not None:
        if (now or time.time()) - peer.last_seen < RECENT_SEEN_S:
            return "online"
    return "offline"
