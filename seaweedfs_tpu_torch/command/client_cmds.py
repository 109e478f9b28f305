"""Client-side subcommands: upload / download / shell / watch / version /
scaffold / backup (reference: weed/command/upload.go, download.go,
shell.go, watch.go, version.go, scaffold.go, backup.go; the port's copy
of `seaweedfs_tpu/command/client_cmds.py`).

`shell -device=cuda|cpu` (default cuda) names where the shell's own
kernel launches run (ec.encode/ec.rebuild -batch); without a card,
`cuda` exits with the reason.
"""

from __future__ import annotations

import json
import os
import sys
import time

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


def run_watch(flags: Flags, args: list[str]) -> int:
    """Tail filer metadata events (command/watch.go) over the filer's
    long-lived push stream — events print the moment they commit; the
    connection redials on filer restarts."""
    from ..filer.client import FilerProxy
    filer = flags.get("filer", "127.0.0.1:8888")
    filer = filer if filer.startswith("http") else f"http://{filer}"
    prefix = flags.get("pathPrefix", "/")
    proxy = FilerProxy(filer)
    since_ns = int(time.time() * 1e9)
    while True:
        try:
            _handle, events = proxy.meta_stream(since_ns=since_ns,
                                                prefix=prefix)
            for ev in events:
                since_ns = max(since_ns, ev.get("ts_ns", since_ns))
                if ev.get("_cursor_only"):
                    continue
                print(json.dumps(ev))
                sys.stdout.flush()
        except KeyboardInterrupt:
            return 130
        except Exception:  # noqa: BLE001 — filer down; redial
            pass
        time.sleep(flags.get_float("interval", 1.0))


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


SCAFFOLDS = {
    "security": '''\
# security.toml — put in ./ , ~/.seaweedfs/ , or /etc/seaweedfs/
[jwt.signing]
key = ""
expires_after_seconds = 10

[access]
ui = false
white_list = []

# TLS for all cluster RPC (reference weed/security/tls.go): every
# server presents its [grpc.<role>] cert; cluster clients dial with
# [grpc.client].  Leave blank for plaintext.
#
# client_auth: "none" (default) serves ordinary TLS so standard
# end-user clients (curl, aws-cli, davfs2, browsers) can connect;
# "require" additionally demands a CA-signed client certificate — the
# reference's mutual-TLS RequireAndVerifyClientCert — appropriate when
# the port is reachable only by cluster peers.
[grpc]
ca = ""

[grpc.master]
cert = ""
key  = ""
# client_auth = "require"

[grpc.volume]
cert = ""
key  = ""
# client_auth = "require"

[grpc.filer]
cert = ""
key  = ""

[grpc.s3]
cert = ""
key  = ""

[grpc.webdav]
cert = ""
key  = ""

[grpc.msg_broker]
cert = ""
key  = ""

[grpc.client]
cert = ""
key  = ""
''',
    "master": '''\
# master.toml
[master.maintenance]
# periodic scripts, one shell command per line
scripts = """
  ec.encode -fullPercent=95 -quietFor=1h
  ec.rebuild -force
  ec.balance -force
  volume.balance -force
"""
sleep_minutes = 17

[master.sequencer]
type = "memory"   # or "etcd"
''',
    "filer": '''\
# filer.toml
[filer.options]
recursive_delete = false

[memory]
enabled = false

[sqlite]
enabled = true
file = "filer.db"

# Embedded ordered-KV store (the reference's leveldb default):
# log-structured, crash-safe, directory-backed.
[ordered_kv]
enabled = false
dir = "."
''',
    "notification": '''\
# notification.toml — the filer publishes every meta event to the
# first enabled queue; `weed filer.replicate` consumes it.
[notification.log]
enabled = false

[notification.file_queue]
enabled = false
dir = "/tmp/weed_notify"

[notification.kafka]
enabled = false
hosts = "localhost:9092"
topic = "seaweedfs_filer"

[notification.aws_sqs]
enabled = false
region = "us-east-1"
sqs_queue_url = "https://sqs.us-east-1.amazonaws.com/1234/queue"
aws_access_key_id = ""
aws_secret_access_key = ""

[notification.google_pub_sub]
enabled = false
project_id = ""
topic = "seaweedfs_filer"
subscription = ""
google_application_credentials = ""
''',
    "replication": '''\
# replication.toml
[source.filer]
enabled = true
grpcAddress = "localhost:8888"
directory = "/buckets"

[sink.filer]
enabled = false
grpcAddress = "localhost:8889"
directory = "/backup"
replication = ""

[sink.local]
enabled = false
directory = "/backup"
''',
}


def run_scaffold(flags: Flags, args: list[str]) -> int:
    """Emit config templates (command/scaffold.go:12-58)."""
    name = flags.get("config", "filer")
    if name not in SCAFFOLDS:
        print(f"unknown config {name!r}; one of {sorted(SCAFFOLDS)}",
              file=sys.stderr)
        return 2
    content = SCAFFOLDS[name]
    out_dir = flags.get("output", "")
    if out_dir:
        path = os.path.join(out_dir, name + ".toml")
        with open(path, "w") as f:
            f.write(content)
        print(f"wrote {path}")
    else:
        print(content, end="")
    return 0


register(Command("upload", "upload -master=host:9333 file1 [file2 ...]",
                 "upload files to the cluster", run_upload))
register(Command("download", "download -server=host:9333 -dir=. fid1 ...",
                 "download files by fid", run_download))
register(Command("shell", "shell -master=host:9333 [-device=cuda|cpu]"
                 " ['cmd1' 'cmd2' ...]",
                 "interactive admin shell", run_shell))
register(Command("watch", "watch -filer=host:8888 -pathPrefix=/",
                 "stream filer metadata change events", run_watch))
register(Command("version", "version", "print version", run_version))
register(Command("backup",
                 "backup -master=host:9333 -volumeId=3 -dir=/backup",
                 "incrementally back up one volume locally",
                 run_backup))
register(Command("scaffold", "scaffold -config=filer [-output=.]",
                 "emit a TOML config template", run_scaffold))
