"""Interactive admin shell (reference: weed/shell/shell_liner.go)."""

from __future__ import annotations

import sys

from .commands import run_command
from .env import CommandEnv, ShellError


def run_shell(master_url: str, commands: list[str] | None = None,
              filer_url: str | None = None, device="cuda") -> int:
    """REPL against a master; with `commands`, run them and exit.
    `device` is where the shell's own kernel launches run (-batch)."""
    env = CommandEnv(master_url, filer_url=filer_url, device=device)
    rc = 0
    try:
        if commands:
            for line in commands:
                try:
                    out = run_command(env, line)
                    if out:
                        print(out)
                except (ShellError, Exception) as e:  # noqa: BLE001
                    print(f"error: {e}", file=sys.stderr)
                    rc = 1
            return rc
        print(f"connected to {master_url} — `help` lists commands, "
              "`exit` quits")
        while True:
            try:
                line = input("> ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip() in ("exit", "quit"):
                break
            try:
                out = run_command(env, line)
                if out:
                    print(out)
            except ShellError as e:
                print(f"error: {e}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — keep the REPL alive
                print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return rc
    finally:
        env.close()
