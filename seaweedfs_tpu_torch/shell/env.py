"""CommandEnv: the shell's connection to the cluster.

Reference: weed/shell/commands.go (CommandEnv with MasterClient + exclusive
lock) and weed/wdclient/exclusive_locks/exclusive_locker.go (the admin
lease that gates mutating commands — `lock`/`unlock`, confirmIsLocked).

`device` ("cuda" by default, or "cpu") is where the shell's own kernel
launches run: the -batch EC paths build their mesh from it, and raise
when it names a card that is not there.
"""

from __future__ import annotations

import threading

import torch

from ..cluster import rpc
from ..cluster.client import WeedClient


class ShellError(Exception):
    pass


class CommandEnv:
    def __init__(self, master_url: str, filer_url: str | None = None,
                 device="cuda"):
        self.master_url = master_url.rstrip("/")
        self.device = torch.device(device)
        self.client = WeedClient(self.master_url)
        self._lock_token: int | None = None
        self._renewer: threading.Timer | None = None
        self.cwd = "/"  # for fs.* commands
        self.filer_url = filer_url.rstrip("/") if filer_url else None

    def filer(self):
        """FilerProxy for fs.* commands (shell -filer=host:8888)."""
        if self.filer_url is None:
            raise ShellError(
                "no filer configured — start the shell with "
                "-filer=host:8888")
        from ..filer.client import FilerProxy
        return FilerProxy(self.filer_url)

    def mesh(self):
        """The batch mesh of the -batch EC paths: every visible card for
        "cuda" (raising without one), else the one device named."""
        from ..ops.erasure import resolve_device
        from ..parallel.cluster_rebuild import make_mesh
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            return make_mesh()
        return make_mesh([dev])

    def resolve(self, path: str) -> str:
        """cwd-relative -> absolute filer path (fs.cd semantics)."""
        import posixpath
        if not path:
            return self.cwd
        if not path.startswith("/"):
            path = posixpath.join(self.cwd, path)
        return posixpath.normpath(path)

    # -- cluster views -------------------------------------------------------

    def topology(self) -> dict:
        return rpc.call(f"{self.master_url}/vol/list")

    def data_nodes(self) -> list[dict]:
        """Flattened node list with dc/rack annotations."""
        out = []
        topo = self.topology()["topology"]
        for dc in topo["data_centers"]:
            for rack in dc["racks"]:
                for n in rack["nodes"]:
                    n = dict(n)
                    n["dc"] = dc["id"]
                    n["rack"] = rack["id"]
                    out.append(n)
        return out

    def volume_locations(self, vid: int) -> list[str]:
        """Always fresh from the master — maintenance decisions must not
        act on the client cache's 60s-stale view."""
        resp = rpc.call(f"{self.master_url}/dir/lookup?volumeId={vid}")
        return [loc["url"] for loc in resp.get("locations", [])]

    def ec_shard_locations(self, vid: int) -> dict[int, list[str]]:
        resp = rpc.call(f"{self.master_url}/dir/lookup?volumeId={vid}")
        return {int(s): [d["url"] for d in dns]
                for s, dns in resp.get("ecShards", {}).items()}

    def ec_codec(self, vid: int) -> str:
        """The erasure codec an EC volume was encoded with, as learned
        by the master from shard-holder heartbeats."""
        resp = rpc.call(f"{self.master_url}/dir/lookup?volumeId={vid}")
        return resp.get("ecCodec", "rs")

    def debug_servers(self, flags: dict) -> list[str]:
        """Base URLs for per-process debug surfaces (/debug/traces,
        /debug/faults, /debug/events): master first, then every
        registered volume server, then the filer — or just the
        -server flag's target.  The shared walk behind trace.ls,
        fault.ls/set, and events.ls."""
        if flags.get("server"):
            url = flags["server"]
            return [url if "://" in url else f"http://{url}"]
        urls = [self.master_url]
        try:
            urls += [f"http://{n['url']}" for n in self.data_nodes()]
        except Exception:  # noqa: BLE001 — master down: others may
            pass           # still answer
        if self.filer_url:
            urls.append(self.filer_url)
        return urls

    # -- volume server RPC shorthands ---------------------------------------

    def vs_call(self, url: str, path: str, payload: dict | None = None,
                timeout: float = 120.0) -> dict:
        return rpc.call_json(f"http://{url}{path}", payload=payload,
                             timeout=timeout)

    # -- exclusive admin lock ------------------------------------------------

    def lock(self, name: str = "shell") -> None:
        resp = rpc.call_json(f"{self.master_url}/admin/lease",
                             payload={"name": name,
                                      "token": self._lock_token})
        self._lock_token = resp["token"]
        ttl = float(resp.get("ttl", 10.0))
        self._schedule_renew(name, ttl / 2)

    def _schedule_renew(self, name: str, delay: float) -> None:
        self._cancel_renew()

        def renew():
            try:
                self.lock(name)
            except Exception:  # noqa: BLE001 — lost the lease; commands
                self._lock_token = None  # will fail confirm_is_locked

        self._renewer = threading.Timer(delay, renew)
        self._renewer.daemon = True
        self._renewer.start()

    def _cancel_renew(self) -> None:
        if self._renewer is not None:
            self._renewer.cancel()
            self._renewer = None

    def unlock(self) -> None:
        self._cancel_renew()
        if self._lock_token is not None:
            rpc.call_json(f"{self.master_url}/admin/release",
                          payload={"token": self._lock_token})
            self._lock_token = None

    def confirm_is_locked(self) -> None:
        if self._lock_token is None:
            raise ShellError(
                "lock is lost, or this command requires the `lock` first")

    def close(self) -> None:
        self._cancel_renew()
        try:
            self.unlock()
        except Exception:  # noqa: BLE001
            pass
