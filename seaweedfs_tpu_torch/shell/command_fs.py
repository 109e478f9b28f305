"""fs.* and bucket.* shell commands: browse and manage the filer
namespace from the admin shell.

Reference: weed/shell/command_fs_cd.go, _ls.go, _du.go, _cat.go,
_tree.go, _mv.go, _rm (via fs delete), _pwd.go, _mkdir,
command_fs_meta_save.go / _load.go / _cat.go, command_bucket_create.go /
_delete.go / _list.go.
"""

from __future__ import annotations

import json

from .commands import Command, register
from .env import CommandEnv, ShellError

BUCKETS_PATH = "/buckets"


@register
class FsPwd(Command):
    name = "fs.pwd"
    help = "fs.pwd — print the current filer directory"

    def do(self, args: list[str], env: CommandEnv) -> str:
        return env.cwd


@register
class FsCd(Command):
    name = "fs.cd"
    help = "fs.cd <dir> — change the current filer directory"

    def do(self, args: list[str], env: CommandEnv) -> str:
        target = env.resolve(args[0] if args else "/")
        if target != "/":
            meta = env.filer().meta(target)
            if meta is None:
                raise ShellError(f"{target}: no such directory")
            if not meta.get("is_directory"):
                raise ShellError(f"{target}: not a directory")
        env.cwd = target
        return ""


@register
class FsLs(Command):
    name = "fs.ls"
    help = "fs.ls [-l] [dir]"

    def do(self, args: list[str], env: CommandEnv) -> str:
        # Boolean flags parsed by hand: the generic parser would eat a
        # following positional as the flag's value.
        long = "-l" in args
        rest = [a for a in args if not a.startswith("-")]
        path = env.resolve(rest[0] if rest else "")
        entries = env.filer().list_all(path)
        if not long:
            return "\n".join(e["name"] + ("/" if e["is_directory"]
                                          else "")
                             for e in entries)
        lines = []
        for e in entries:
            kind = "d" if e["is_directory"] else "-"
            mode = e.get("mode", 0)
            lines.append(f"{kind}{mode & 0o7777:04o} "
                         f"{e.get('size', 0):>12} {e['name']}")
        return "\n".join(lines)


@register
class FsDu(Command):
    name = "fs.du"
    help = "fs.du [dir] — recursive size/file/dir counts"

    def do(self, args: list[str], env: CommandEnv) -> str:
        root = env.resolve(args[0] if args else "")
        proxy = env.filer()
        total, files, dirs = 0, 0, 0
        stack = [root]
        while stack:
            d = stack.pop()
            for e in proxy.list_all(d):
                if e["is_directory"]:
                    dirs += 1
                    stack.append(e["FullPath"])
                else:
                    files += 1
                    total += e.get("size", 0)
        return (f"{total} bytes, {files} files, {dirs} directories "
                f"under {root}")


@register
class FsCat(Command):
    name = "fs.cat"
    help = "fs.cat <file>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        import urllib.error
        if not args:
            raise ShellError("usage: fs.cat <file>")
        path = env.resolve(args[0])
        try:
            with env.filer().get(path) as resp:
                return resp.read().decode("utf-8", "replace")
        except urllib.error.HTTPError as e:
            raise ShellError(f"{path}: HTTP {e.code}") from None


@register
class FsTree(Command):
    name = "fs.tree"
    help = "fs.tree [dir]"

    def do(self, args: list[str], env: CommandEnv) -> str:
        root = env.resolve(args[0] if args else "")
        proxy = env.filer()
        lines = [root]

        def walk(d: str, prefix: str) -> None:
            entries = proxy.list_all(d)
            for i, e in enumerate(entries):
                last = i == len(entries) - 1
                branch = "└── " if last else "├── "
                lines.append(prefix + branch + e["name"] +
                             ("/" if e["is_directory"] else ""))
                if e["is_directory"]:
                    walk(e["FullPath"],
                         prefix + ("    " if last else "│   "))
        walk(root, "")
        return "\n".join(lines)


@register
class FsMkdir(Command):
    name = "fs.mkdir"
    help = "fs.mkdir <dir>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        if not args:
            raise ShellError("usage: fs.mkdir <dir>")
        env.filer().mkdir(env.resolve(args[0]))
        return ""


@register
class FsMv(Command):
    name = "fs.mv"
    help = "fs.mv <src> <dst>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        if len(args) != 2:
            raise ShellError("usage: fs.mv <src> <dst>")
        src, dst = env.resolve(args[0]), env.resolve(args[1])
        env.filer().rename(src, dst)
        return f"moved {src} -> {dst}"


@register
class FsRm(Command):
    name = "fs.rm"
    help = "fs.rm [-r] <path>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        recursive = "-r" in args
        rest = [a for a in args if not a.startswith("-")]
        if not rest:
            raise ShellError("usage: fs.rm [-r] <path>")
        path = env.resolve(rest[0])
        if not env.filer().delete(path, recursive=recursive):
            raise ShellError(f"{path}: not found")
        return f"removed {path}"


# -- metadata export/import (command_fs_meta_save.go / _load.go) -----------

@register
class FsMetaSave(Command):
    name = "fs.meta.save"
    help = ("fs.meta.save [-o=meta.jsonl] [dir] — dump entries (with "
            "chunk lists) as JSONL")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, rest = self.parse_flags(args)
        root = env.resolve(rest[0] if rest else "")
        out_path = flags.get("o", "filer-meta.jsonl")
        proxy = env.filer()
        count = 0
        with open(out_path, "w") as f:
            stack = [root]
            while stack:
                d = stack.pop()
                for e in proxy.list_all(d):
                    full = proxy.meta(e["FullPath"])
                    if full is not None:
                        f.write(json.dumps(full,
                                           separators=(",", ":"))
                                + "\n")
                        count += 1
                    if e["is_directory"]:
                        stack.append(e["FullPath"])
        return f"saved {count} entries from {root} to {out_path}"


@register
class FsMetaLoad(Command):
    name = "fs.meta.load"
    help = "fs.meta.load <meta.jsonl> — re-create entries from a dump"

    def do(self, args: list[str], env: CommandEnv) -> str:
        if not args:
            raise ShellError("usage: fs.meta.load <meta.jsonl>")
        proxy = env.filer()
        count = 0
        with open(args[0]) as f:
            for line in f:
                if not line.strip():
                    continue
                entry = json.loads(line)
                if entry.get("is_directory"):
                    proxy.mkdir(entry["path"])
                else:
                    proxy.create_entry(entry["path"], entry)
                count += 1
        return f"loaded {count} entries"


@register
class FsMetaNotify(Command):
    """Walk a subtree and publish one create event per entry to the
    notification queue (command_fs_meta_notify.go) — bootstraps a
    freshly-attached replication sink with the existing namespace."""
    name = "fs.meta.notify"
    help = ("fs.meta.notify [-queue=<spec>] [dir] — publish a create "
            "event per entry (queue from notification.toml when no "
            "-queue)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        from ..replication.notification import (queue_for_spec,
                                                queue_from_config)
        flags, rest = self.parse_flags(args)
        root = env.resolve(rest[0] if rest else "")
        spec = flags.get("queue", "")
        if spec:
            queue = queue_for_spec(spec)
        else:
            from ..utils.config import load_configuration
            queue = queue_from_config(
                load_configuration("notification"))
            if queue is None:
                raise ShellError(
                    "no notification queue: enable one in "
                    "notification.toml or pass -queue=<spec>")
        proxy = env.filer()
        count = 0
        stack = [root]
        while stack:
            d = stack.pop()
            for e in proxy.list_all(d):
                full = proxy.meta(e["FullPath"])
                if full is not None:
                    queue.publish(e["FullPath"],
                                  {"directory": d, "old_entry": None,
                                   "new_entry": full})
                    count += 1
                if e["is_directory"]:
                    stack.append(e["FullPath"])
        queue.close()
        return f"notified {count} entries under {root}"


@register
class FsMetaCat(Command):
    name = "fs.meta.cat"
    help = "fs.meta.cat <path> — print one entry's full metadata"

    def do(self, args: list[str], env: CommandEnv) -> str:
        if not args:
            raise ShellError("usage: fs.meta.cat <path>")
        meta = env.filer().meta(env.resolve(args[0]))
        if meta is None:
            raise ShellError(f"{args[0]}: not found")
        return json.dumps(meta, indent=2)


# -- buckets (command_bucket_*.go) -----------------------------------------

@register
class BucketList(Command):
    name = "bucket.list"
    help = "bucket.list"

    def do(self, args: list[str], env: CommandEnv) -> str:
        entries = env.filer().list_all(BUCKETS_PATH)
        return "\n".join(e["name"] for e in entries
                         if e["is_directory"]) or "no buckets"


@register
class BucketCreate(Command):
    name = "bucket.create"
    help = "bucket.create -name <bucket>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, rest = self.parse_flags(args)
        name = flags.get("name") or (rest[0] if rest else "")
        if not name:
            raise ShellError("bucket.create requires -name <bucket>")
        env.filer().mkdir(f"{BUCKETS_PATH}/{name}")
        return f"created bucket {name}"


@register
class BucketDelete(Command):
    name = "bucket.delete"
    help = "bucket.delete -name <bucket>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, rest = self.parse_flags(args)
        name = flags.get("name") or (rest[0] if rest else "")
        if not name:
            raise ShellError("bucket.delete requires -name <bucket>")
        if not env.filer().delete(f"{BUCKETS_PATH}/{name}",
                                  recursive=True):
            raise ShellError(f"bucket {name} not found")
        return f"deleted bucket {name}"
