"""Replication subcommands: filer.copy / filer.replicate.

Reference: weed/command/filer_copy.go (local tree -> filer upload) and
filer_replication.go (notification queue -> Replicator -> sink).

The old `filer.sync` polling daemon was removed: cross-cluster
mirroring is now the volume-level change-log shipper (-replicate.peer
on the volume server, replication/rlog.py + shipper.py), which is
durable, idempotent, and cutover-verified — properties the mtime-diff
walk never had.
"""

from __future__ import annotations

import mimetypes
import os
import sys
import time

from . import Command, Flags, register


def _filer_url(flags: Flags, key: str = "filer") -> str:
    addr = flags.get(key, "127.0.0.1:8888")
    return addr if addr.startswith("http") else f"http://{addr}"


def run_filer_copy(flags: Flags, args: list[str]) -> int:
    """filer.copy local_file_or_dir ... /target/dir/"""
    from ..filer.client import FilerProxy
    if len(args) < 2:
        print("usage: filer.copy [-filer=host:8888] src... /dest/dir/",
              file=sys.stderr)
        return 1
    *sources, dest = args
    if not dest.startswith("/"):
        print("destination must be an absolute filer path",
              file=sys.stderr)
        return 1
    proxy = FilerProxy(_filer_url(flags))
    dest = dest.rstrip("/") or "/"
    n = 0
    for src in sources:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            for root, _dirs, files in os.walk(src):
                rel = os.path.relpath(root, src)
                for fname in files:
                    local = os.path.join(root, fname)
                    remote = "/".join(p for p in (
                        dest, base, "" if rel == "." else rel, fname)
                        if p).replace("//", "/")
                    n += _copy_one(proxy, local, remote)
        elif os.path.isfile(src):
            n += _copy_one(proxy, src,
                           f"{dest}/{os.path.basename(src)}")
        else:
            print(f"skip {src}: not found", file=sys.stderr)
    print(f"copied {n} files to {dest}")
    return 0


def _copy_one(proxy, local: str, remote: str) -> int:
    mime = mimetypes.guess_type(local)[0] or "application/octet-stream"
    # Stream the open file: filer.copy of a multi-GB file must not
    # materialize it (the proxy sends readers under Content-Length and
    # the filer's upload route consumes incrementally).
    with open(local, "rb") as f:
        # fstat the OPEN handle: a path-level stat could disagree with
        # the descriptor under a concurrent replace, declaring a length
        # the body never matches (hung or truncated upload).
        proxy.put(remote, f, mime,
                  length=os.fstat(f.fileno()).st_size)
    return 1


def run_filer_replicate(flags: Flags, args: list[str]) -> int:
    """filer.replicate -filer=... -source.dir=/bucket -sink=<spec>

    Sink specs: filer://host:port/dir, local:///path, s3://host/bucket,
    gcs://bucket/dir, b2://bucket/dir, azure://account/container/dir.
    Consumes the filer's meta stream (notification input) and replays it
    on the sink; checkpoints its offset in the source filer KV."""
    from ..filer.client import FilerProxy
    from ..replication.replicator import Replicator
    from ..replication.sink import sink_for_spec
    src = _filer_url(flags)
    src_dir = flags.get("source.dir", "/")
    spec = flags.get("sink", "")
    if not spec:
        print("missing -sink=<spec>", file=sys.stderr)
        return 1
    scheme = spec.partition("://")[0]
    kw = {}
    if scheme in ("s3", "gcs", "b2"):
        kw = {"access_key": flags.get("s3.access_key", ""),
              "secret_key": flags.get("s3.secret_key", "")}
        if flags.get("s3.region"):
            kw["region"] = flags.get("s3.region")
    elif scheme == "azure":
        kw = {"account_key": flags.get("azure.account_key", "")}
    # -sink.endpoint: point a cloud sink at an emulator or
    # S3-interop proxy instead of the vendor default host.
    if scheme in ("gcs", "b2", "azure") and flags.get("sink.endpoint"):
        kw["endpoint"] = flags.get("sink.endpoint")
    sink = sink_for_spec(spec, **kw)
    repl = Replicator(src, src_dir, sink)
    proxy = FilerProxy(src)
    ck_key = f"replicate.offset.{spec}"
    raw = proxy.kv_get(ck_key)
    offset = int(raw) if raw else 0
    one_shot = flags.get_bool("once")
    interval = flags.get_float("interval", 1.0)
    print(f"replicating {src}{src_dir} -> {spec} from offset {offset}")
    try:
        while True:
            # A transient sink/source error must not kill the daemon:
            # skip the checkpoint and retry the batch next tick.
            try:
                out = proxy.meta_events(since_ns=offset, prefix=src_dir)
                for ev in out["events"]:
                    repl.replicate(ev)
            except Exception as e:  # noqa: BLE001
                print(f"replicate batch failed (will retry): {e}",
                      file=sys.stderr)
                if one_shot:
                    return 1
                time.sleep(interval)
                continue
            if out["last_ns"] > offset:
                offset = out["last_ns"]
                proxy.kv_put(ck_key, str(offset).encode())
            elif one_shot:
                return 0
            else:
                time.sleep(interval)
    except KeyboardInterrupt:
        return 0


register(Command(
    "filer.copy", "filer.copy [-filer=host:8888] src... /dest/dir/",
    "copy local files or directories into the filer", run_filer_copy))
register(Command(
    "filer.replicate",
    "filer.replicate -filer=host:8888 -sink=local:///backup",
    "replicate filer changes to a sink (filer/local/s3/gcs/b2/azure)",
    run_filer_replicate))
