"""lock/unlock, collection.*, cluster status commands.

Reference: weed/shell/command_fs_lock_unlock.go, command_collection_*.go,
command_cluster_ps-style status.
"""

from __future__ import annotations

from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError


@register
class Lock(Command):
    name = "lock"
    help = "lock — acquire the exclusive admin lock (required by mutators)"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.lock()
        return "locked"


@register
class Unlock(Command):
    name = "unlock"
    help = "unlock — release the exclusive admin lock"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.unlock()
        return "unlocked"


@register
class CollectionList(Command):
    name = "collection.list"
    help = "collection.list"

    def do(self, args: list[str], env: CommandEnv) -> str:
        resp = rpc.call(f"{env.master_url}/col/list")
        cols = resp.get("collections", [])
        return "\n".join(c or "(default)" for c in cols) or "no collections"


@register
class CollectionDelete(Command):
    name = "collection.delete"
    help = "collection.delete -collection <name>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, rest = self.parse_flags(args)
        name = flags.get("collection") or (rest[0] if rest else "")
        if not name:
            # An empty name would match the default collection and delete
            # every non-collection volume in the cluster.
            raise ShellError(
                "collection.delete requires -collection <name>")
        resp = rpc.call_json(
            f"{env.master_url}/col/delete?collection={name}")
        return (f"deleted collection {name!r} "
                f"({resp.get('deleted_replicas', 0)} replicas)")


@register
class ClusterStatus(Command):
    name = "cluster.status"
    help = "cluster.status — leader + basic cluster info"

    def do(self, args: list[str], env: CommandEnv) -> str:
        resp = rpc.call(f"{env.master_url}/cluster/status")
        return "\n".join(f"{k}: {v}" for k, v in sorted(resp.items()))
