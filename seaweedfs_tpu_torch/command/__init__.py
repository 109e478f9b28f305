"""CLI command registry + dispatcher of the port (reference:
weed/command/command.go:10-32, weed/weed.go:38-80;
seaweedfs_tpu/command/__init__.py).

Every subcommand registers a `Command(name, usage, help, run)`; `main`
dispatches `weed <name> [flags]`.  Commands accept Go-style single-dash
flags (`-port 9333` or `-port=9333`) like the reference so existing muscle
memory and scripts carry over.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Callable

from ..utils import glog


@dataclass
class Command:
    name: str
    usage: str
    short: str
    run: Callable[["Flags", list[str]], int]
    flag_defs: dict[str, tuple[str, str]] = field(default_factory=dict)
    # flag -> (default, help); all flags parse as strings, converted by use


class Flags:
    """Parsed `-key value` / `-key=value` flags with typed getters."""

    def __init__(self, values: dict[str, str]):
        self._v = values

    def get(self, key: str, default: str = "") -> str:
        return self._v.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        val = self._v.get(key)
        return int(val) if val not in (None, "") else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        val = self._v.get(key)
        return float(val) if val not in (None, "") else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._v.get(key)
        if val is None:
            return default
        return val.lower() in ("", "1", "true", "yes", "on")

    def __contains__(self, key: str) -> bool:
        return key in self._v


def parse_flags(args: list[str]) -> tuple[Flags, list[str]]:
    flags: dict[str, str] = {}
    rest: list[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--":
            rest.extend(args[i + 1:])
            break
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            key = a.lstrip("-")
            if "=" in key:
                key, val = key.split("=", 1)
                flags[key] = val
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                flags[key] = args[i + 1]
                i += 1
            else:
                flags[key] = ""  # bare boolean flag
        else:
            rest.append(a)
        i += 1
    return Flags(flags), rest


COMMANDS: dict[str, Command] = {}


def register(cmd: Command) -> None:
    COMMANDS[cmd.name] = cmd


def _load_all() -> None:
    # Import for registration side effects.
    from . import benchmark_cmd  # noqa: F401
    from . import client_cmds  # noqa: F401
    from . import mount_cmd  # noqa: F401
    from . import offline_cmds  # noqa: F401
    from . import replication_cmds  # noqa: F401
    from . import servers  # noqa: F401


def usage() -> str:
    _load_all()
    lines = ["usage: weed <command> [flags] [args]", "", "commands:"]
    for name in sorted(COMMANDS):
        lines.append(f"  {name:<18} {COMMANDS[name].short}")
    lines += [
        "",
        "global flags (any command):",
        "  -v <level>            glog verbosity (glog.v(n) gates; "
        "env WEED_V)",
        "  -events.file <path>   append cluster events as JSONL "
        "(journal persistence)",
        "  -events.file.max_mb <mb> / -events.file.keep <n>   rotate "
        "the JSONL sink by size, keeping n rotated files",
        "  -events.buffer <n>    event ring capacity (default 2048); "
        "-events=false unmounts /debug/events + /cluster/events",
        "  -debug.traces / -debug.faults   mount /debug/traces and "
        "/debug/faults",
        "  -pprof                mount /debug/pprof + start the "
        "always-on continuous profiler",
        "  -pprof.hz / -pprof.window       sampler rate (default 19) "
        "and ring-window seconds (default 60)",
        "  -lock.meter=false / -phases=false   disarm lock-contention "
        "metering / the request phase ledger",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _load_all()
    if not argv or argv[0] in ("-h", "-help", "--help", "help"):
        print(usage())
        return 0
    name, args = argv[0], argv[1:]
    cmd = COMMANDS.get(name)
    if cmd is None:
        print(f"unknown command {name!r}\n\n{usage()}", file=sys.stderr)
        return 2
    flags, rest = parse_flags(args)
    # Global -v <level> wires glog verbosity on every command (server
    # roles included) so `glog.v(n)` gates actually fire; without the
    # flag the WEED_V env still applies (setup's None path) instead of
    # being clobbered to 0.
    glog.setup(verbosity=flags.get_int("v", 0) if "v" in flags
               else None)
    # Offset width flavor: the reference's 5BytesOffset BUILD tag
    # (storage/types/offset_5bytes.go) as a process-wide config —
    # `-offsetBytes=5` on any command, or WEED_OFFSET_BYTES=5.
    offset_bytes = flags.get_int(
        "offsetBytes", int(os.environ.get("WEED_OFFSET_BYTES", "4")))
    if offset_bytes != 4:
        from ..core.types import set_offset_flavor
        set_offset_flavor(offset_bytes)
    # -cpuprofile/-memprofile on any subcommand (grace.SetupProfiling):
    # begin profiling now, dump at process exit.
    if flags.get("cpuprofile") or flags.get("memprofile"):
        from ..utils.pprof import setup_profiling
        setup_profiling(flags.get("cpuprofile", ""),
                        flags.get("memprofile", ""))
    # Distributed-tracing knobs, process-wide on any server command
    # (trace/tracer.py reads these env vars dynamically; flags just set
    # them before servers construct):  -debug.traces mounts the
    # /debug/traces endpoint (operator opt-in, like pprof);
    # -trace.sample / -trace.slowMs tune head sampling and the
    # always-sample slow threshold; -trace=false disables recording.
    if flags.get_bool("debug.traces", False):
        os.environ["SEAWEEDFS_TPU_TRACES"] = "1"
    if "trace" in flags and not flags.get_bool("trace", True):
        os.environ["SEAWEEDFS_TPU_TRACE"] = "0"
    if flags.get("trace.sample"):
        os.environ["SEAWEEDFS_TPU_TRACE_SAMPLE"] = flags.get("trace.sample")
    if flags.get("trace.slowMs"):
        os.environ["SEAWEEDFS_TPU_TRACE_SLOW_MS"] = flags.get("trace.slowMs")
    # Time-attribution plane knobs (utils/pprof.py, stats/contention,
    # stats/phases read these when servers construct): -pprof mounts
    # the /debug/pprof surface AND starts the always-on continuous
    # profiler; -pprof.hz / -pprof.window tune its sample rate and
    # ring-window size; -pprof.continuous=false keeps the routes but
    # not the sampler; -lock.meter=false and -phases=false disarm
    # lock metering / the per-request phase ledger (the overhead-bench
    # toggles — both default on).
    if flags.get_bool("pprof", False):
        os.environ["SEAWEEDFS_TPU_PPROF"] = "1"
    if flags.get("pprof.hz"):
        os.environ["SEAWEEDFS_TPU_PPROF_HZ"] = flags.get("pprof.hz")
    if flags.get("pprof.window"):
        os.environ["SEAWEEDFS_TPU_PPROF_WINDOW"] = \
            flags.get("pprof.window")
    if "pprof.continuous" in flags and \
            not flags.get_bool("pprof.continuous", True):
        os.environ["SEAWEEDFS_TPU_PPROF_CONTINUOUS"] = "0"
    if "lock.meter" in flags and not flags.get_bool("lock.meter", True):
        os.environ["SEAWEEDFS_TPU_LOCK_METER"] = "0"
        from ..stats import contention
        contention.ENABLED = False
    if "phases" in flags and not flags.get_bool("phases", True):
        os.environ["SEAWEEDFS_TPU_PHASES"] = "0"
        from ..stats import phases
        phases.ENABLED = False
    # Fault-injection / resilience knobs (fault/registry.py and
    # cluster/resilience.py read these env vars when the first server
    # constructs — after this block):  -faults "point=spec;..." arms
    # fault points at boot AND mounts /debug/faults; -debug.faults
    # mounts the endpoint unarmed (runtime arming via fault.set);
    # -faults.seed replays a probabilistic chaos run;
    # -breaker.threshold / -breaker.cooldown tune the per-host circuit
    # breaker in the rpc client pool (threshold 0 disables it).
    if flags.get("faults"):
        os.environ["SEAWEEDFS_TPU_FAULTS"] = flags.get("faults")
    elif flags.get_bool("debug.faults", False):
        os.environ["SEAWEEDFS_TPU_FAULTS"] = ""
    if flags.get("faults.seed"):
        os.environ["SEAWEEDFS_TPU_FAULTS_SEED"] = \
            flags.get("faults.seed")
    if flags.get("breaker.threshold"):
        os.environ["SEAWEEDFS_TPU_BREAKER_THRESHOLD"] = \
            flags.get("breaker.threshold")
    if flags.get("breaker.cooldown"):
        os.environ["SEAWEEDFS_TPU_BREAKER_COOLDOWN"] = \
            flags.get("breaker.cooldown")
    # Event-journal knobs (events/journal.py reads these when servers
    # construct):  -events.file appends every event as a JSONL line
    # (durable timeline beyond the in-memory ring); -events.buffer
    # sizes the ring; -events=false is the kill switch that also
    # unmounts /debug/events.
    if flags.get("events.file"):
        os.environ["SEAWEEDFS_TPU_EVENTS_FILE"] = \
            flags.get("events.file")
    if flags.get("events.buffer"):
        os.environ["SEAWEEDFS_TPU_EVENTS_BUFFER"] = \
            flags.get("events.buffer")
    # -events.file.max_mb / -events.file.keep: size-based rotation of
    # the JSONL sink (path -> path.1 -> ... -> path.N, keep N).
    if flags.get("events.file.max_mb"):
        os.environ["SEAWEEDFS_TPU_EVENTS_FILE_MAX_MB"] = \
            flags.get("events.file.max_mb")
    if flags.get("events.file.keep"):
        os.environ["SEAWEEDFS_TPU_EVENTS_FILE_KEEP"] = \
            flags.get("events.file.keep")
    if "events" in flags and not flags.get_bool("events", True):
        os.environ["SEAWEEDFS_TPU_EVENTS"] = "0"
    # Device roofline kill switch (stats/roofline.py reads it at
    # import and via set_armed): -roofline=false disarms per-kernel
    # work accounting and the pipeline occupancy recorder — the
    # disarmed path is a single flag check per kernel call.
    if "roofline" in flags and not flags.get_bool("roofline", True):
        os.environ["SEAWEEDFS_TPU_ROOFLINE"] = "0"
        from ..stats import roofline
        roofline.set_armed(False)
    # Wire-flow budget knobs (stats/flows.py reads these lazily):
    # -flows.budget declares per-purpose bandwidth ceilings
    # ("repair.fetch=50MB/s,rlog.ship=10MB/s" — 1024-based units,
    # "/s" optional); a sustained breach emits a flows.budget event
    # and a /cluster/healthz warning.  -flows.sustain sets how many
    # seconds over the ceiling count as sustained (default 2).
    if flags.get("flows.budget"):
        os.environ["SEAWEEDFS_TPU_FLOWS_BUDGET"] = \
            flags.get("flows.budget")
    if flags.get("flows.sustain"):
        os.environ["SEAWEEDFS_TPU_FLOWS_SUSTAIN"] = \
            flags.get("flows.sustain")
    # Every cluster-dialing command — servers AND clients (upload,
    # shell, mount, …) — goes through the TLS plane when security.toml
    # configures [grpc.client], matching the reference where each
    # command's gRPC dials go through security.LoadClientTLS.  A broken
    # security.toml fails closed with a message; exempt are the
    # commands needed to repair it and the offline local-file tools
    # that never dial the cluster.
    if name not in ("scaffold", "version", "fix", "compact", "export"):
        from ..utils.security import (install_cluster_tls,
                                      security_configuration)
        try:
            install_cluster_tls(security_configuration())
        except Exception as e:  # noqa: BLE001 — bad TOML / cert paths
            print(f"security.toml: {e}\n(fix it, or regenerate with "
                  f"`weed scaffold -config=security`)", file=sys.stderr)
            return 2
    try:
        return cmd.run(flags, rest)
    except KeyboardInterrupt:
        return 130
