"""Built-in server startup scripts (the port's copy of
``fleetflow_tpu/cloud/startup_scripts.py``).

Analog of fleetflow-cloud-sakura/src/startup_scripts.rs: named scripts a
`server { startup-script "..." }` declaration can reference without
shipping shell files around. On Sakura they are registered as cloud
"notes" and attached at create time (provider.rs:131-190 note_ids path);
on AWS the same content rides --user-data. Scripts are our own minimal
cloud-init-style bootstrap — the reference's capabilities (docker engine,
agent install, build-worker init), not its shell text.

Every script is idempotent (safe on reboot with @sacloud-once absent) and
ends by touching a sentinel under /var/lib/fleetflow so `ssh exec` health
checks can verify bootstrap completion.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["get_builtin_script", "is_builtin_script", "substitute_vars",
           "BUILTIN_SCRIPTS"]


def substitute_vars(content: str, script_vars: Optional[dict],
                    context: str = "") -> str:
    """Replace @@VAR@@ placeholders; any placeholder left unsubstituted is
    a LOUD error — a fleet-agent unit with a literal @@CP_ENDPOINT@@ would
    otherwise boot with a garbage endpoint and silently never join."""
    import re

    from ..core.errors import CloudError
    for k, v in (script_vars or {}).items():
        content = content.replace(f"@@{k}@@", str(v))
    leftover = sorted(set(re.findall(r"@@([A-Z0-9_]+)@@", content)))
    if leftover:
        raise CloudError(
            f"startup script {context or '<inline>'!r} needs variables "
            f"{leftover}; pass them via script_vars / the provider "
            f"declaration's script-vars option")
    return content

_SENTINEL = "mkdir -p /var/lib/fleetflow && touch /var/lib/fleetflow/{name}.done"

DOCKER_SETUP = f"""#!/bin/bash
# fleetflow builtin: docker-setup — container engine for fleet nodes
set -euo pipefail
if ! command -v docker >/dev/null 2>&1; then
    export DEBIAN_FRONTEND=noninteractive
    apt-get update -qq
    apt-get install -y -qq ca-certificates curl
    install -m 0755 -d /etc/apt/keyrings
    curl -fsSL https://download.docker.com/linux/ubuntu/gpg \\
        -o /etc/apt/keyrings/docker.asc
    echo "deb [signed-by=/etc/apt/keyrings/docker.asc] \\
https://download.docker.com/linux/ubuntu $(. /etc/os-release; \\
echo "$VERSION_CODENAME") stable" > /etc/apt/sources.list.d/docker.list
    apt-get update -qq
    apt-get install -y -qq docker-ce docker-ce-cli containerd.io \\
        docker-compose-plugin
fi
systemctl enable --now docker
{_SENTINEL.format(name="docker-setup")}
"""

AGENT_SETUP = f"""#!/bin/bash
# fleetflow builtin: agent-setup — install + start the fleet node agent
# Variables: @@CP_ENDPOINT@@ (host:port), @@SERVER_SLUG@@, @@CA_PEM_B64@@
set -euo pipefail
install -d -m 0750 /etc/fleetflow /var/lib/fleetflow
if [ -n "@@CA_PEM_B64@@" ]; then
    echo "@@CA_PEM_B64@@" | base64 -d > /etc/fleetflow/cp-ca.pem
fi
cat > /etc/systemd/system/fleet-agent.service <<'UNIT'
[Unit]
Description=fleetflow node agent
After=network-online.target docker.service
Wants=network-online.target

[Service]
ExecStart=/usr/local/bin/fleet agent \\
    --cp-endpoint @@CP_ENDPOINT@@ --server-slug @@SERVER_SLUG@@ \\
    --ca /etc/fleetflow/cp-ca.pem
Restart=always
RestartSec=5

[Install]
WantedBy=multi-user.target
UNIT
systemctl daemon-reload
systemctl enable --now fleet-agent || true
{_SENTINEL.format(name="agent-setup")}
"""

WORKER_INIT = f"""#!/bin/bash
# fleetflow builtin: worker-init — ephemeral build-worker bootstrap with
# idle auto-shutdown (the reference ships this as scripts/idle-shutdown.sh
# + a systemd timer; same capability, one script)
set -euo pipefail
cat > /usr/local/bin/fleetflow-idle-check <<'CHECK'
#!/bin/bash
# shut down when no build has touched the marker for 30 minutes
marker=/var/lib/fleetflow/last-build
[ -f "$marker" ] || exit 0
age=$(( $(date +%s) - $(stat -c %Y "$marker") ))
[ "$age" -gt 1800 ] && systemctl poweroff
exit 0
CHECK
chmod +x /usr/local/bin/fleetflow-idle-check
cat > /etc/systemd/system/fleetflow-idle.timer <<'TIMER'
[Unit]
Description=fleetflow idle shutdown check

[Timer]
OnBootSec=10min
OnUnitActiveSec=5min

[Install]
WantedBy=timers.target
TIMER
cat > /etc/systemd/system/fleetflow-idle.service <<'SVC'
[Unit]
Description=fleetflow idle shutdown

[Service]
Type=oneshot
ExecStart=/usr/local/bin/fleetflow-idle-check
SVC
systemctl daemon-reload
systemctl enable --now fleetflow-idle.timer
mkdir -p /var/lib/fleetflow && touch /var/lib/fleetflow/last-build
{_SENTINEL.format(name="worker-init")}
"""

BUILTIN_SCRIPTS: dict[str, str] = {
    "docker-setup": DOCKER_SETUP,
    "agent-setup": AGENT_SETUP,
    "worker-init": WORKER_INIT,
}


def get_builtin_script(name: str) -> Optional[str]:
    """startup_scripts.rs get_builtin_script:195."""
    return BUILTIN_SCRIPTS.get(name)


def is_builtin_script(name: str) -> bool:
    return name in BUILTIN_SCRIPTS
