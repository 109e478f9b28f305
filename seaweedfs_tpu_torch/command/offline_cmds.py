"""Offline volume-file subcommands: fix / compact / export
(reference: weed/command/fix.go, compact.go, export.go).

These operate directly on `.dat`/`.idx` files with no servers running —
the same administrative escape hatches the reference ships.
`backup` (incremental pull from a live volume server) lives in
client_cmds.py.

The port's copy of `seaweedfs_tpu/command/offline_cmds.py`.
"""

from __future__ import annotations

import os
import sys
import tarfile
import time

from . import Command, Flags, register


def _volume_base(flags: Flags) -> str:
    d = flags.get("dir", ".")
    collection = flags.get("collection", "")
    vid = flags.get_int("volumeId", -1)
    if vid < 0:
        print("-volumeId is required", file=sys.stderr)
        raise SystemExit(2)
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(d, name)


def run_fix(flags: Flags, args: list[str]) -> int:
    """Regenerate .idx from .dat (command/fix.go)."""
    from ..storage.volume_scanner import generate_idx_from_dat
    base = _volume_base(flags)
    count = generate_idx_from_dat(base + ".dat", base + ".idx")
    print(f"wrote {base}.idx ({count} entries)")
    return 0


def run_compact(flags: Flags, args: list[str]) -> int:
    """Offline vacuum: copy live needles into fresh .dat/.idx
    (command/compact.go)."""
    from ..storage.vacuum import commit_compact, compact
    from ..storage.volume import Volume
    base = _volume_base(flags)
    vol = Volume(flags.get("dir", "."), flags.get("collection", ""),
                 flags.get_int("volumeId"))
    try:
        before = vol.dat_size()
        snapshot = compact(vol)
        commit_compact(vol, snapshot)
        print(f"compacted {base}.dat: {before} -> {vol.dat_size()} bytes")
    finally:
        vol.close()
    return 0


def run_export(flags: Flags, args: list[str]) -> int:
    """Export live needles as a .tar, or list them with -fileNameFormat=
    none (command/export.go)."""
    from ..storage.volume_scanner import scan_volume_file
    base = _volume_base(flags)
    out_path = flags.get("o", "")
    newer_than = flags.get("newer", "")
    newer_ns = 0
    if newer_than:
        newer_ns = int(time.mktime(
            time.strptime(newer_than, "%Y-%m-%d %H:%M:%S"))) * 10**9
    tar = tarfile.open(out_path, "w") if out_path else None
    count = 0
    # Append order is authoritative: the newest record per id wins, and a
    # tombstone (size<=0) erases any earlier version (same liveness rule
    # `weed fix` uses to rebuild the .idx).
    latest: dict[int, tuple] = {}
    for needle, offset, total in scan_volume_file(base + ".dat"):
        if needle.size <= 0:
            latest.pop(needle.id, None)
        else:
            latest[needle.id] = (needle, offset, total)
    try:
        for needle, offset, _total in latest.values():
            if newer_ns and needle.append_at_ns < newer_ns:
                continue
            name = (needle.name.decode("utf-8", "replace")
                    if needle.name else f"{needle.id:x}")
            if needle.is_compressed() and not name.endswith(".gz"):
                # gzip-stored needle: export the stored bytes honestly
                # (command/export.go appends .gz the same way)
                name += ".gz"
            if tar is not None:
                info = tarfile.TarInfo(name=name)
                info.size = len(needle.data)
                info.mtime = (needle.append_at_ns // 10**9) or \
                    int(time.time())
                import io
                tar.addfile(info, io.BytesIO(needle.data))
            else:
                print(f"{needle.id:x}\t{name}\t{len(needle.data)}\t"
                      f"offset={offset}")
            count += 1
    finally:
        if tar is not None:
            tar.close()
    dest = out_path or "stdout"
    print(f"exported {count} files from {base}.dat to {dest}",
          file=sys.stderr)
    return 0


register(Command("fix", "fix -dir=/data -volumeId=3 [-collection=c]",
                 "rebuild the .idx by scanning the .dat", run_fix))
register(Command("compact", "compact -dir=/data -volumeId=3",
                 "offline vacuum of one volume", run_compact))
register(Command("export",
                 "export -dir=/data -volumeId=3 -o=vol.tar [-newer='...']",
                 "export live needles to tar / listing", run_export))
