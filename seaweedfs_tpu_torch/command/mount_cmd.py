"""weed mount: mount the filer as a local FUSE filesystem.

Reference: weed/command/mount.go + weed/filesys/ (bazil FUSE there;
ctypes libfuse here — see mount/fuse_ll.py; the port's copy of
seaweedfs_tpu/command/mount_cmd.py).
"""

from __future__ import annotations

import ctypes
import os
import sys

from . import Command, Flags, register


def run_mount(flags: Flags, args: list[str]) -> int:
    from ..mount.fuse_ll import FuseMount
    from ..mount.vfs import WFS
    mountpoint = flags.get("dir", "")
    if not mountpoint:
        print("missing -dir=<mountpoint>", file=sys.stderr)
        return 1
    if not os.path.isdir(mountpoint):
        print(f"mountpoint {mountpoint} is not a directory",
              file=sys.stderr)
        return 1
    # A host without FUSE fails here, naming what is missing, before
    # the filer is dialled; the command never goes on without a mount.
    if not os.path.exists("/dev/fuse"):
        print("cannot mount: /dev/fuse is missing on this host",
              file=sys.stderr)
        return 1
    try:
        ctypes.CDLL("libfuse.so.2")
    except OSError as e:
        print(f"cannot mount: libfuse.so.2 did not load ({e})",
              file=sys.stderr)
        return 1
    filer = flags.get("filer", "127.0.0.1:8888")
    filer_url = filer if filer.startswith("http") else f"http://{filer}"
    wfs = WFS(filer_url,
              filer_dir=flags.get("filer.path", "/"),
              collection=flags.get("collection", ""),
              replication=flags.get("replication", ""),
              chunk_size=flags.get_int("chunkSizeLimitMB", 4)
              * 1024 * 1024)
    fm = FuseMount(wfs, mountpoint,
                   allow_other=flags.get_bool("allowOthers"))
    print(f"mounting {filer_url}{wfs.root} at {mountpoint}")
    try:
        fm.mount(foreground=True)
    except KeyboardInterrupt:
        fm.unmount()
    return 0


register(Command(
    "mount", "mount -filer=host:8888 -dir=/mnt/weed [-filer.path=/]",
    "mount the filer as a local FUSE filesystem", run_mount))
