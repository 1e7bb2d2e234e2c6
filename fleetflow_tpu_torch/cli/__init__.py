"""User surfaces (L6): the `fleet` CLI.

Analog of crates/fleetflow (SURVEY.md §2.3): the clap command tree becomes
an argparse tree with the same groups — Daily (up/down/restart/ps/logs/
exec), Ship (build/deploy), Admin (cp subgroups), Util (validate/solve/
init/mcp) — plus the placement preview `fleet solve`, which places on the
card (`--device cpu` runs the card scheduler's plain versions, `--host`
the host greedy placer).
"""

from .main import main

__all__ = ["main"]
