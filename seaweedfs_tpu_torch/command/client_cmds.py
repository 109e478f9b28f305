"""Client-side subcommands: upload / download / shell / version /
backup (reference: weed/command/upload.go, download.go, shell.go,
version.go, backup.go; the port's copy of
`seaweedfs_tpu/command/client_cmds.py`).

`shell -device=cuda|cpu` (default cuda) names where the shell's own
kernel launches run (ec.encode/ec.rebuild -batch); without a card,
`cuda` exits with the reason.  `watch` and `scaffold` wait for the filer
(ROADMAP queue 1, slice 11).
"""

from __future__ import annotations

import json
import os
import sys

from .. import __version__
from . import Command, Flags, register


def _master(flags: Flags, key: str = "master") -> str:
    addr = flags.get(key, "127.0.0.1:9333")
    return addr if addr.startswith("http") else f"http://{addr}"


def run_upload(flags: Flags, args: list[str]) -> int:
    """Upload files (or a directory with -dir); prints JSON results like
    the reference (command/upload.go)."""
    from ..cluster.client import WeedClient
    client = WeedClient(_master(flags))
    paths: list[str] = []
    if flags.get("dir"):
        for root, _dirs, files in os.walk(flags.get("dir")):
            paths.extend(os.path.join(root, f) for f in files)
    paths.extend(args)
    if not paths:
        print("nothing to upload: pass files or -dir", file=sys.stderr)
        return 2
    results = []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        res = client.submit(data, collection=flags.get("collection", ""),
                            replication=flags.get("replication") or None,
                            ttl=flags.get("ttl", ""))
        res["fileName"] = os.path.basename(p)
        # submit() passes the full upload dict through, including the
        # bytes cipher_key (b"" when no cipher); hex it for the JSON
        # report instead of crashing json.dumps.
        results.append({k: (v.hex() if isinstance(v, bytes) else v)
                        for k, v in res.items()})
    print(json.dumps(results, indent=2))
    return 0


def run_download(flags: Flags, args: list[str]) -> int:
    """Download fids to -dir (command/download.go)."""
    from ..cluster.client import WeedClient
    client = WeedClient(_master(flags, "server"))
    out_dir = flags.get("dir", ".")
    os.makedirs(out_dir, exist_ok=True)
    for fid in args:
        data = client.download(fid)
        name = fid.replace(",", "_")
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        print(f"{fid} -> {name} ({len(data)} bytes)")
    return 0


def run_shell(flags: Flags, args: list[str]) -> int:
    from ..shell.repl import run_shell
    from .servers import _device_flag
    device = _device_flag(flags)
    filer = flags.get("filer", "")
    if filer and not filer.startswith("http"):
        filer = f"http://{filer}"
    return run_shell(_master(flags), commands=args or None,
                     filer_url=filer or None, device=device)


def run_backup(flags: Flags, args: list[str]) -> int:
    """weed backup: keep an incremental local copy of one volume
    (command/backup.go + storage/volume_backup.go IncrementalBackup).
    First run copies the whole .dat; later runs fetch only records
    appended since the local copy's newest appendAtNs."""
    from ..cluster import rpc
    from ..storage.volume_backup import (apply_incremental,
                                         last_append_at_ns)
    master = _master(flags)
    vid = flags.get_int("volumeId", 0)
    out_dir = flags.get("dir", ".")
    if not vid:
        print("missing -volumeId", file=sys.stderr)
        return 1
    lookup = rpc.call(f"{master}/dir/lookup?volumeId={vid}")
    locs = lookup.get("locations", [])
    if not locs:
        print(f"volume {vid} has no locations", file=sys.stderr)
        return 1
    node = locs[0]["url"]
    os.makedirs(out_dir, exist_ok=True)
    dat_path = os.path.join(out_dir, f"{vid}.dat")
    idx_path = os.path.join(out_dir, f"{vid}.idx")
    if not os.path.exists(dat_path):
        # Full copy (VolumeCopy's CopyFile path).  The .idx comes FIRST
        # so on a live volume the idx snapshot can never reference
        # offsets past the .dat snapshot's EOF.
        rpc.call_to_file(
            f"http://{node}/admin/volume_file?volume={vid}&ext=.idx",
            idx_path)
        rpc.call_to_file(
            f"http://{node}/admin/volume_file?volume={vid}&ext=.dat",
            dat_path)
        print(f"full backup of volume {vid} -> {dat_path}")
        return 0
    since = last_append_at_ns(dat_path)
    import urllib.request
    url = (f"http://{node}/admin/volume_tail?volume={vid}"
           f"&since_ns={since}")
    applied_total = 0
    while True:
        with urllib.request.urlopen(url, timeout=600) as resp:
            delta = resp.read()
            version = int(resp.headers.get("X-Volume-Version", "3"))
            last = int(resp.headers.get("X-Last-Append-Ns", since))
        if not delta:
            break
        applied_total += apply_incremental(dat_path, idx_path, delta,
                                           version)
        if last <= since:
            break
        since = last
        url = (f"http://{node}/admin/volume_tail?volume={vid}"
               f"&since_ns={since}")
    print(f"incremental backup of volume {vid}: "
          f"{applied_total} records appended")
    return 0


def run_version(flags: Flags, args: list[str]) -> int:
    print(f"version {__version__} (seaweedfs-tpu)")
    return 0


register(Command("upload", "upload -master=host:9333 file1 [file2 ...]",
                 "upload files to the cluster", run_upload))
register(Command("download", "download -server=host:9333 -dir=. fid1 ...",
                 "download files by fid", run_download))
register(Command("shell", "shell -master=host:9333 [-device=cuda|cpu]"
                 " ['cmd1' 'cmd2' ...]",
                 "interactive admin shell", run_shell))
register(Command("version", "version", "print version", run_version))
register(Command("backup",
                 "backup -master=host:9333 -volumeId=3 -dir=/backup",
                 "incrementally back up one volume locally",
                 run_backup))
