"""Cloudflare provider: DNS REST + wrangler Pages (the port's copy of
``fleetflow_tpu/cloud/cloudflare.py``).

Analog of fleetflow-cloud-cloudflare (SURVEY.md §2.7): DNS record CRUD +
`ensure` upsert against the Cloudflare v4 REST API (dns.rs:77-349, via
urllib with CLOUDFLARE_API_TOKEN), and a `wrangler` CLI wrapper for Pages
deploys (wrangler.rs). The HTTP transport is injectable; without a token
`check_auth` is False. This is also the CP's default `dns_backend` shape
(cp handlers dns.sync expects `ensure_record`).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import urllib.request
from typing import Callable, Optional

from ..core.errors import CloudError
from ..core.model import CloudProviderDecl, ServerResource
from .action import Action, ActionType, ApplyResult, Plan
from .provider import CloudProvider, register_provider
from .state import ProviderState

__all__ = ["CloudflareDns", "CloudflareProvider", "wrangler_pages_deploy",
           "wrangler_pages_dev"]

API = "https://api.cloudflare.com/client/v4"
TOKEN_ENV = "CLOUDFLARE_API_TOKEN"

Transport = Callable[[str, str, Optional[dict]], dict]


def _default_transport(token: str) -> Transport:
    def call(method: str, path: str, body: Optional[dict]) -> dict:
        req = urllib.request.Request(
            API + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Authorization": f"Bearer {token}",
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except Exception:
                raise CloudError(f"cloudflare API {method} {path}: "
                                 f"HTTP {e.code}") from None
        except urllib.error.URLError as e:
            raise CloudError(f"cloudflare API unreachable: {e.reason}") from None
    return call


class CloudflareDns:
    """dns.rs:77-349."""

    def __init__(self, token: Optional[str] = None,
                 transport: Optional[Transport] = None):
        self.token = token or os.environ.get(TOKEN_ENV, "")
        self.transport = transport or (_default_transport(self.token)
                                       if self.token else None)
        self._zone_cache: dict[str, str] = {}

    def _call(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        if self.transport is None:
            raise CloudError(f"no cloudflare credentials ({TOKEN_ENV} unset)")
        doc = self.transport(method, path, body)
        if not doc.get("success", False):
            errs = "; ".join(str(e.get("message", e))
                             for e in doc.get("errors", []))
            raise CloudError(f"cloudflare API error: {errs or 'unknown'}")
        return doc

    def zone_id(self, zone: str) -> str:
        if zone not in self._zone_cache:
            doc = self._call("GET", f"/zones?name={zone}")
            rows = doc.get("result", [])
            if not rows:
                raise CloudError(f"zone {zone!r} not found")
            self._zone_cache[zone] = rows[0]["id"]
        return self._zone_cache[zone]

    def list_records(self, zone: str) -> list[dict]:
        zid = self.zone_id(zone)
        return self._call("GET", f"/zones/{zid}/dns_records?per_page=500"
                          ).get("result", [])

    def find_record(self, zone: str, name: str,
                    rtype: str = "A") -> Optional[dict]:
        fqdn = name if name.endswith(zone) else f"{name}.{zone}"
        zid = self.zone_id(zone)
        rows = self._call(
            "GET", f"/zones/{zid}/dns_records?name={fqdn}&type={rtype}"
        ).get("result", [])
        return rows[0] if rows else None

    def create_record(self, zone: str, name: str, rtype: str, content: str,
                      *, ttl: int = 300, proxied: bool = False) -> dict:
        zid = self.zone_id(zone)
        return self._call("POST", f"/zones/{zid}/dns_records", {
            "name": name, "type": rtype, "content": content,
            "ttl": ttl, "proxied": proxied})["result"]

    def update_record(self, zone: str, record_id: str, *, content: str,
                      ttl: int = 300, proxied: bool = False) -> dict:
        zid = self.zone_id(zone)
        return self._call("PATCH", f"/zones/{zid}/dns_records/{record_id}", {
            "content": content, "ttl": ttl, "proxied": proxied})["result"]

    def delete_record(self, zone: str, record_id: str) -> bool:
        zid = self.zone_id(zone)
        self._call("DELETE", f"/zones/{zid}/dns_records/{record_id}")
        return True

    def ensure_record(self, zone: str, name: str, rtype: str, content: str,
                      *, ttl: int = 300, proxied: bool = False) -> dict:
        """dns.rs ensure A/CNAME: create or update to match."""
        existing = self.find_record(zone, name, rtype)
        if existing is None:
            return self.create_record(zone, name, rtype, content,
                                      ttl=ttl, proxied=proxied)
        if (existing.get("content") != content
                or existing.get("ttl") != ttl
                or existing.get("proxied") != proxied):
            return self.update_record(zone, existing["id"], content=content,
                                      ttl=ttl, proxied=proxied)
        return existing


class CloudflareProvider(CloudProvider):
    name = "cloudflare"

    def __init__(self, token: Optional[str] = None, transport=None):
        self.dns = CloudflareDns(token=token, transport=transport)

    def check_auth(self) -> bool:
        return self.dns.transport is not None

    def get_state(self) -> ProviderState:
        return ProviderState(provider=self.name)   # zone-scoped on demand

    def plan(self, decl: CloudProviderDecl,
             servers: list[ServerResource]) -> Plan:
        """Diff declared dns_hostname/dns_aliases against the zone."""
        zone = str(decl.options.get("zone", decl.zone or ""))
        plan = Plan(provider=self.name)
        if not zone:
            return plan
        for spec in servers:
            for name in ([spec.dns_hostname] if spec.dns_hostname else []) \
                    + list(spec.dns_aliases):
                existing = (self.dns.find_record(zone, name)
                            if self.check_auth() else None)
                ip = spec.ssh_host
                if not ip:
                    # not provisioned yet: nothing valid to create
                    plan.actions.append(Action(
                        ActionType.NOOP, "dns_record", name,
                        "pending (no address yet)"))
                elif existing is None:
                    plan.actions.append(Action(
                        ActionType.CREATE, "dns_record", name,
                        f"A -> {ip}", desired={"content": ip, "zone": zone}))
                elif existing.get("content") != ip:
                    plan.actions.append(Action(
                        ActionType.UPDATE, "dns_record", name,
                        f"{existing.get('content')} -> {ip}",
                        desired={"content": ip, "zone": zone},
                        current=existing))
                else:
                    plan.actions.append(Action(
                        ActionType.NOOP, "dns_record", name, "in sync"))
        return plan

    def apply(self, plan: Plan) -> ApplyResult:
        result = ApplyResult()
        for action in plan.changes:
            try:
                desired = action.desired or {}
                zone = desired.get("zone")   # the zone plan() diffed against
                content = desired.get("content")
                if not zone or not content:
                    raise CloudError(
                        f"action for {action.resource_id} carries no "
                        "zone/content (was this plan built by this provider?)")
                self.dns.ensure_record(zone, action.resource_id, "A", content)
                result.succeeded.append(action)
            except CloudError as e:
                result.failed.append((action, str(e)))
        return result


def _wrangler(args: list[str], cwd: Optional[str] = None,
              runner=None) -> tuple[int, str]:
    if runner is not None:
        return runner(["wrangler", *args])
    if shutil.which("wrangler") is None:
        raise CloudError("wrangler CLI not found (npm i -g wrangler)")
    proc = subprocess.run(["wrangler", *args], cwd=cwd,
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def wrangler_pages_deploy(output_dir: str, project: str, *,
                          cwd: Optional[str] = None,
                          runner=None) -> str:
    """wrangler.rs pages deploy (the reference's static-site deploy path,
    deploy.rs:265-352)."""
    rc, out = _wrangler(["pages", "deploy", output_dir,
                         "--project-name", project], cwd=cwd, runner=runner)
    if rc != 0:
        raise CloudError(f"wrangler pages deploy failed: {out[-1000:]}")
    return out


def wrangler_pages_dev(output_dir: str, *, port: int = 8788,
                       cwd: Optional[str] = None) -> subprocess.Popen:
    """The `fleet up` static-service dev server (up.rs:139-195)."""
    if shutil.which("wrangler") is None:
        raise CloudError("wrangler CLI not found")
    return subprocess.Popen(["wrangler", "pages", "dev", output_dir,
                             "--port", str(port)], cwd=cwd)


# -- Pages project management (beyond deploy/dev) -------------------------

def pages_project_list(runner=None) -> list[dict]:
    """`wrangler pages project list` — names + domains. Wrangler prints a
    table, not JSON; parse the body rows."""
    rc, out = _wrangler(["pages", "project", "list"], runner=runner)
    if rc != 0:
        raise CloudError(f"pages project list failed: {out[-500:]}")
    projects = []
    for line in out.splitlines():
        # table rows: │ name │ domains │ ... (skip borders/header)
        cells = [c.strip() for c in line.strip().strip("│|").split("│" if "│" in line else "|")]
        if len(cells) >= 2 and cells[0] and cells[0].lower() not in (
                "project name", "name") and not set(line) <= set("─┼│+-| "):
            projects.append({"name": cells[0],
                             "domains": cells[1] if len(cells) > 1 else ""})
    return projects


def pages_project_create(project: str, *, production_branch: str = "main",
                         runner=None) -> None:
    rc, out = _wrangler(["pages", "project", "create", project,
                         "--production-branch", production_branch],
                        runner=runner)
    if rc != 0:
        raise CloudError(f"pages project create failed: {out[-500:]}")


def pages_project_delete(project: str, *, runner=None) -> None:
    rc, out = _wrangler(["pages", "project", "delete", project, "--yes"],
                        runner=runner)
    if rc != 0:
        raise CloudError(f"pages project delete failed: {out[-500:]}")


def ensure_pages_project(project: str, *, production_branch: str = "main",
                         runner=None) -> bool:
    """Create the Pages project when absent (the reference deploys assume
    the project exists; this closes the first-deploy gap). Returns True
    when it had to create."""
    names = {p["name"] for p in pages_project_list(runner=runner)}
    if project in names:
        return False
    pages_project_create(project, production_branch=production_branch,
                         runner=runner)
    return True


# -- R2 buckets + workers (wrangler.rs:101-147) -----------------------------

def r2_bucket_list(runner=None) -> list[str]:
    """wrangler.rs list_r2_buckets:101 (`wrangler r2 bucket list` prints
    'name: <bucket>' stanzas)."""
    rc, out = _wrangler(["r2", "bucket", "list"], runner=runner)
    if rc != 0:
        raise CloudError(f"r2 bucket list failed: {out[-500:]}")
    return [ln.split(":", 1)[1].strip() for ln in out.splitlines()
            if ln.strip().lower().startswith("name:")]


def r2_bucket_create(name: str, runner=None) -> None:
    rc, out = _wrangler(["r2", "bucket", "create", name], runner=runner)
    if rc != 0:
        raise CloudError(f"r2 bucket create failed: {out[-500:]}")


def r2_bucket_delete(name: str, runner=None) -> None:
    rc, out = _wrangler(["r2", "bucket", "delete", name], runner=runner)
    if rc != 0:
        raise CloudError(f"r2 bucket delete failed: {out[-500:]}")


def worker_list(account_id: str, *, token: Optional[str] = None,
                transport: Optional[Transport] = None) -> list[str]:
    """Account-wide worker script names over the REST API
    (GET /accounts/{id}/workers/scripts). The reference stubs this as a
    TODO returning [] (wrangler.rs:126-129) because no wrangler
    subcommand enumerates account workers; the dash API does, and the
    same Transport seam the DNS client uses makes it testable."""
    token = token or os.environ.get(TOKEN_ENV, "")
    transport = transport or (_default_transport(token) if token else None)
    if transport is None:
        # the credential-less path answers [] so enumeration-shaped
        # callers (cleanup sweeps, dashboards) keep working — but a
        # misconfigured provider must be VISIBLE as degradation, never
        # read as "no workers" (the upstream project stubbed this whole
        # call as a silent TODO [])
        from .provider import note_degraded
        note_degraded("cloudflare", f"{TOKEN_ENV} unset")
        return []
    doc = transport("GET", f"/accounts/{account_id}/workers/scripts", None)
    if not doc.get("success", False):
        errs = "; ".join(str(e.get("message", e))
                         for e in doc.get("errors", []))
        raise CloudError(f"cloudflare API error: {errs or 'unknown'}")
    return [r.get("id", "") for r in doc.get("result", []) if r.get("id")]


def worker_delete(name: str, runner=None) -> None:
    """wrangler.rs delete_worker:140."""
    rc, out = _wrangler(["delete", "--name", name, "--force"], runner=runner)
    if rc != 0:
        raise CloudError(f"worker delete failed: {out[-500:]}")


register_provider("cloudflare", CloudflareProvider)
