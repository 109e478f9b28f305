"""Command interface + registry (reference: weed/shell/commands.go:35-53).

Each command is a subclass with `name`, `help`, and
`do(args, env) -> str` returning its printed output.  `run_command`
parses a shell line and dispatches.
"""

from __future__ import annotations

import shlex

from .env import CommandEnv, ShellError

COMMANDS: dict[str, "Command"] = {}


class Command:
    name = ""
    help = ""

    def do(self, args: list[str], env: CommandEnv) -> str:
        raise NotImplementedError

    # -- tiny flag parser (the reference uses Go's flag.FlagSet) ------------

    @staticmethod
    def parse_flags(args: list[str]) -> tuple[dict[str, str], list[str]]:
        """-key value / -key=value pairs -> dict; the rest positional."""
        flags: dict[str, str] = {}
        rest: list[str] = []
        i = 0
        while i < len(args):
            a = args[i]
            if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
                key = a.lstrip("-")
                if "=" in key:
                    key, val = key.split("=", 1)
                    flags[key] = val
                elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                    flags[key] = args[i + 1]
                    i += 1
                else:
                    flags[key] = "true"
            else:
                rest.append(a)
            i += 1
        return flags, rest


def register(cls: type[Command]) -> type[Command]:
    COMMANDS[cls.name] = cls()
    return cls


def run_command(env: CommandEnv, line: str) -> str:
    parts = shlex.split(line)
    if not parts:
        return ""
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        if args and args[0] in COMMANDS:
            return COMMANDS[args[0]].help
        return "\n".join(sorted(COMMANDS))
    cmd = COMMANDS.get(name)
    if cmd is None:
        raise ShellError(f"unknown command: {name} (try `help`)")
    return cmd.do(args, env)
