"""`fleet self-update` (the reference's self_update.rs:4).

The reference checks GitHub Releases for a newer tag, picks the platform
asset (darwin/linux x amd64/arm64 tar.gz), downloads and swaps the binary,
and falls back to `cargo install` when no prebuilt asset exists
(self_update.rs:55-95).  Here the installable unit is a Python package, so
the swap step becomes `pip install --upgrade` from the release artifact;
the fetcher is injectable so the decision logic tests offline.
"""

from __future__ import annotations

import json
import platform
import sys
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional

from .. import __version__

__all__ = ["RELEASES_URL", "UpdatePlan", "is_newer_version", "pick_asset",
           "plan_update", "self_update"]

RELEASES_URL = ("https://api.github.com/repos/chronista-club/"
                "fleetflow/releases/latest")


def is_newer_version(latest: str, current: str) -> bool:
    """Numeric dotted-version comparison (self_update.rs is_newer_version):
    '0.10.2' > '0.9.9'; non-numeric segments compare as 0."""
    def parts(v: str) -> list[int]:
        out = []
        for seg in v.strip().lstrip("v").split("."):
            digits = "".join(ch for ch in seg if ch.isdigit())
            out.append(int(digits) if digits else 0)
        return out
    a, b = parts(latest), parts(current)
    length = max(len(a), len(b))
    a += [0] * (length - len(a))
    b += [0] * (length - len(b))
    return a > b


def pick_asset(os_name: Optional[str] = None,
               arch: Optional[str] = None) -> Optional[str]:
    """Platform asset name, or None when unsupported
    (self_update.rs:55-68)."""
    os_name = os_name or sys.platform
    arch = arch or platform.machine()
    os_key = {"darwin": "darwin", "linux": "linux"}.get(
        "darwin" if os_name.startswith("darwin") else
        "linux" if os_name.startswith("linux") else os_name)
    arch_key = {"x86_64": "amd64", "amd64": "amd64",
                "arm64": "arm64", "aarch64": "arm64"}.get(arch.lower())
    if os_key is None or arch_key is None:
        return None
    return f"fleetflow-{os_key}-{arch_key}.tar.gz"


@dataclass
class UpdatePlan:
    current: str
    latest: str
    update_needed: bool
    asset: Optional[str] = None          # matched release asset name
    download_url: Optional[str] = None
    fallback_pip: bool = False           # no prebuilt asset → pip path


def plan_update(release: dict, current: str = __version__,
                os_name: Optional[str] = None,
                arch: Optional[str] = None) -> UpdatePlan:
    """Pure decision step over a GitHub release JSON document."""
    latest = str(release.get("tag_name", "")).lstrip("v")
    if not latest:
        raise ValueError("release document has no tag_name")
    if not is_newer_version(latest, current):
        return UpdatePlan(current=current, latest=latest, update_needed=False)
    asset_name = pick_asset(os_name, arch)
    url = None
    if asset_name:
        for asset in release.get("assets", []) or []:
            if asset.get("name") == asset_name:
                url = asset.get("browser_download_url")
                break
    return UpdatePlan(current=current, latest=latest, update_needed=True,
                      asset=asset_name if url else None,
                      download_url=url, fallback_pip=url is None)


def _default_fetcher(url: str) -> dict:
    req = urllib.request.Request(url, headers={"User-Agent": "fleetflow"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read().decode())


def self_update(fetcher: Callable[[str], dict] = _default_fetcher,
                print_fn: Callable[[str], None] = print,
                dry_run: bool = False) -> int:
    """CLI entry: check, report, and (unless dry_run) apply the update."""
    print_fn(f"fleet self-update\ncurrent version: {__version__}")
    try:
        release = fetcher(RELEASES_URL)
    except Exception as e:  # network failure must not crash the CLI
        print_fn(f"could not reach GitHub releases: {e}")
        return 1
    try:
        plan = plan_update(release)
    except ValueError as e:
        print_fn(f"bad release document: {e}")
        return 1
    print_fn(f"latest version: {plan.latest}")
    if not plan.update_needed:
        print_fn("already up to date")
        return 0
    if dry_run:
        how = (f"download {plan.download_url}" if plan.download_url
               else "pip install --upgrade (no prebuilt asset)")
        print_fn(f"would update {plan.current} -> {plan.latest} via {how}")
        return 0
    import subprocess
    if plan.fallback_pip:
        # the reference's cargo-install fallback (self_update.rs:79-95)
        argv = [sys.executable, "-m", "pip", "install", "--upgrade",
                f"fleetflow-tpu=={plan.latest}"]
    else:
        argv = [sys.executable, "-m", "pip", "install", "--upgrade",
                plan.download_url]
    print_fn(f"updating {plan.current} -> {plan.latest}: {' '.join(argv)}")
    rc = subprocess.call(argv)
    if rc == 0:
        print_fn(f"updated to {plan.latest}")
    return rc
