"""`.vif` VolumeInfo sidecar.

The reference stores a protobuf VolumeInfo next to volume/shard files
(weed/pb/volume_info.go, maybeLoadVolumeInfo) carrying the needle version
and tiering info; EC shard copies bring it along so a server holding only
parity shards still knows how to size records.  Ours carries the same
fields as JSON (the sidecar is operational metadata, not part of the
byte-compat surface) plus the erasure codec id ("codec": "rs" | "lrc"),
which is how a mounted EC volume knows which generator matrix produced
its shards — the codec travels with every shard copy exactly like the
needle version does.
"""

from __future__ import annotations

import json
import os


def save_volume_info(base_file_name: str, version: int,
                     files: list[dict] | None = None,
                     codec: str | None = None) -> None:
    payload = {"version": version}
    if files:
        payload["files"] = files
    if codec and codec != "rs":
        # rs is the implied default: absent-field compatibility with
        # every .vif written before codecs existed.
        payload["codec"] = codec
    tmp = base_file_name + ".vif.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, base_file_name + ".vif")


def update_volume_info(base_file_name: str, **fields) -> None:
    """Merge fields into an existing .vif (or create one): lets the
    encoder record the codec without clobbering version/tier info a
    caller wrote earlier."""
    existing = load_volume_info(base_file_name)
    info = dict(existing or {})
    for k, v in fields.items():
        if v is None or (k == "codec" and v == "rs"):
            info.pop(k, None)
        else:
            info[k] = v
    if not info and existing is None:
        return  # nothing to record; don't create an empty sidecar
    tmp = base_file_name + ".vif.tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, base_file_name + ".vif")


def load_volume_info(base_file_name: str) -> dict | None:
    try:
        with open(base_file_name + ".vif") as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def ec_codec_name(base_file_name: str) -> str:
    """The codec an EC volume's shards were generated with ("rs" when
    the sidecar is absent or predates codecs)."""
    info = load_volume_info(base_file_name)
    if info:
        return str(info.get("codec", "rs"))
    return "rs"
