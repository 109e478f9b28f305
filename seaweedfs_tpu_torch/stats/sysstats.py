"""Disk and memory statistics (reference: weed/stats/disk.go, memory.go).
"""

from __future__ import annotations

import os


def disk_status(path: str) -> dict:
    """Filesystem usage for the volume holding `path`
    (disk.go fillInDiskStatus via syscall.Statfs)."""
    st = os.statvfs(path)
    total = st.f_blocks * st.f_frsize
    free = st.f_bavail * st.f_frsize
    used = total - st.f_bfree * st.f_frsize
    return {"dir": path, "all": total, "used": used, "free": free,
            "percent_free": (free / total * 100.0) if total else 0.0,
            "percent_used": (used / total * 100.0) if total else 0.0}


def proc_cpu_seconds() -> float:
    """CPU seconds (user+system) consumed by this process so far.
    Exposed by every server's status endpoint so `weed benchmark
    -cpu=true` can sample server-side cost around a load phase and
    report requests per core-second — the hardware-independent number
    the multi-core reference baseline is compared against."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def memory_status() -> dict:
    """Process memory from /proc/self/status (memory.go), falling back
    to getrusage off-Linux so the volume server's RSS gauge and /debug
    status stay meaningful on macOS (no procfs there; ru_maxrss is the
    peak RSS — bytes on macOS, kilobytes on Linux)."""
    out = {"rss": 0, "vms": 0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith("VmSize:"):
                    out["vms"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    if not out["rss"]:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out["rss"] = peak if sys.platform == "darwin" else peak * 1024
    return out
