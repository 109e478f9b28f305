"""Volume tiering: move a volume's .dat to a remote backend.

weed/storage/volume_tier.go:11-32 (the `.vif` VolumeInfo
sidecar + maybeLoadVolumeInfo/LoadRemoteFile),
server/volume_grpc_tier_upload.go (VolumeTierMoveDatToRemote) and
_download.go (back).  The `.idx` stays local; needle reads proxy
through ranged reads against the backend.
"""

from __future__ import annotations

import json
import os
import time

from .backend import backend_for_spec
from .volume import Volume, VolumeError


def vif_path(base: str) -> str:
    return base + ".vif"


def save_vif(base: str, info: dict) -> None:
    tmp = vif_path(base) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=1)
    os.replace(tmp, vif_path(base))


def load_vif(base: str) -> dict | None:
    try:
        with open(vif_path(base)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def tier_key(collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return f"{name}.dat"


def move_dat_to_remote(volume: Volume, dest_spec: str,
                       keep_local: bool = False,
                       access_key: str = "",
                       secret_key: str = "") -> dict:
    """Upload the .dat, write the .vif sidecar, switch the volume to
    remote reads.  The volume must be readonly (SeaweedFS requires
    the same)."""
    if volume.remote_file is not None:
        raise VolumeError(f"volume {volume.vid} is already remote")
    if not volume.readonly:
        raise VolumeError(
            f"volume {volume.vid} must be readonly before tiering")
    backend = backend_for_spec(dest_spec, access_key, secret_key)
    base = volume.file_name()
    key = tier_key(volume.collection, volume.vid)
    volume.sync()
    want = os.path.getsize(base + ".dat")
    try:
        size = backend.upload_file(key, base + ".dat")
    except Exception:  # noqa: BLE001
        # A previously-crashed upload can leave a partial/stale object
        # at the key and some backends refuse the overwrite.  Clear it
        # and re-upload once; a second failure propagates with the
        # volume still fully local (.vif not yet written).
        try:
            backend.delete(key)
        except Exception:  # noqa: BLE001
            pass
        size = backend.upload_file(key, base + ".dat")
    if size != want:
        # Never publish a .vif pointing at a short object; the local
        # .dat is still authoritative.
        try:
            backend.delete(key)
        except Exception:  # noqa: BLE001
            pass
        raise VolumeError(
            f"tier upload of volume {volume.vid} wrote {size} bytes, "
            f"local .dat has {want}")
    # No credentials in the sidecar: the .vif sits on the data dir and
    # must never leak keys (SeaweedFS keeps backend credentials in
    # centrally-distributed config) — they come from server config/env
    # at open time.
    # modified_at is the volume's newest-WRITE time, not the upload
    # time: TTL expiry decisions must survive the round-trip through
    # the remote tier.
    info = {"volume_id": volume.vid, "version": volume.version,
            "collection": volume.collection,
            "files": [{"backend_spec": dest_spec, "key": key,
                       "file_size": size,
                       "modified_at": int(getattr(
                           volume, "modified_at", 0) or time.time())}]}
    save_vif(base, info)
    # The fd swap rides the same write lock vacuum uses, so a reader
    # mid-pread can never observe a closed fd.
    with volume._file_lock.write():
        volume.remote_file = backend.open_file(key, size)
        dat = volume._dat
        volume._dat = None
    if dat is not None:
        dat.close()
    if not keep_local:
        os.remove(base + ".dat")
    from ..events import emit as emit_event
    from ..stats import flows as _flows
    from ..stats import metrics as _metrics
    _metrics.tier_moved_bytes_total.inc(size, direction="upload")
    # Tier transfers bypass the rpc plane (backend SDK / file copy):
    # feed the wire-flow ledger directly, peer = the backend spec.
    _flows.LEDGER.note("tier.up", "out", size, peer=dest_spec,
                       peer_role="remote")
    emit_event("tier.move", vid=volume.vid, direction="upload",
               dest=dest_spec, bytes=size, keep_local=keep_local)
    return info


def _tier_credentials() -> tuple[str, str]:
    """Backend credentials from server-level config (env), NOT from the
    .vif (which must stay secret-free)."""
    return (os.environ.get("WEED_TIER_ACCESS_KEY", ""),
            os.environ.get("WEED_TIER_SECRET_KEY", ""))


def move_dat_from_remote(volume: Volume, keep_remote: bool = False,
                         access_key: str = "",
                         secret_key: str = "") -> None:
    """Download the .dat back and resume local reads
    (VolumeTierMoveDatFromRemote)."""
    base = volume.file_name()
    info = load_vif(base)
    if info is None or volume.remote_file is None:
        raise VolumeError(f"volume {volume.vid} is not tiered")
    fdesc = info["files"][0]
    if not access_key:
        access_key, secret_key = _tier_credentials()
    backend = backend_for_spec(fdesc["backend_spec"],
                               access_key, secret_key)
    # Download to a temp name and os.replace only after verifying the
    # byte count: a crash mid-download must never leave a truncated
    # .dat beside a live .vif (the remount would prefer the torn local
    # copy over the intact remote one).
    tmp = base + ".dat.tmpdl"
    try:
        os.remove(tmp)
    except FileNotFoundError:
        pass
    got = backend.download_file(fdesc["key"], tmp)
    want = fdesc.get("file_size")
    if want is not None and got != want:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise VolumeError(
            f"tier download of volume {volume.vid} got {got} bytes, "
            f".vif records {want}")
    os.replace(tmp, base + ".dat")
    with volume._file_lock.write():
        remote = volume.remote_file
        volume._dat = open(base + ".dat", "r+b")
        volume.remote_file = None
    remote.close()
    # The remote copy may be deleted next; stale cached blocks must not
    # outlive it (a re-tier to the same key would serve old bytes).
    from .remote_cache import CACHE
    CACHE.drop_file(fdesc["backend_spec"], fdesc["key"])
    os.remove(vif_path(base))
    if not keep_remote:
        backend.delete(fdesc["key"])
    from ..events import emit as emit_event
    from ..stats import flows as _flows
    from ..stats import metrics as _metrics
    _metrics.tier_moved_bytes_total.inc(got, direction="download")
    _flows.LEDGER.note("tier.down", "in", got,
                       peer=fdesc["backend_spec"], peer_role="remote")
    emit_event("tier.move", vid=volume.vid, direction="download",
               source=fdesc["backend_spec"],
               bytes=fdesc.get("file_size", 0),
               keep_remote=keep_remote)


def open_remote_volume(dir_: str, collection: str, vid: int) -> Volume:
    """Open a tiered volume from its .vif + local .idx (the startup
    path when the .dat is absent — maybeLoadVolumeInfo)."""
    name = f"{collection}_{vid}" if collection else str(vid)
    base = os.path.join(dir_, name)
    info = load_vif(base)
    if info is None or not info.get("files"):
        # A files-less .vif is EC/version metadata (ec/volume_info.py),
        # not a tier marker.
        raise VolumeError(f"volume {vid} at {base} is not tiered")
    fdesc = info["files"][0]
    ak, sk = _tier_credentials()
    backend = backend_for_spec(fdesc["backend_spec"], ak, sk)
    remote = backend.open_file(fdesc["key"], fdesc["file_size"])
    v = Volume(dir_, collection, vid, create=False,
               remote_file=remote)
    v.modified_at = float(fdesc.get("modified_at", 0) or 0)
    return v
