"""The `.ecc` sidecar's format (seaweedfs_tpu_torch/ec/integrity.py):
JSON {"block": 1048576, "shards": {"0": ["9ae1f203", ...], ...}}, one
CRC32-C per block of each shard file, as 8 hex digits."""

from __future__ import annotations

import json


def dumps(block: int, shards: dict[int, list[int]]) -> str:
    return json.dumps({"block": block,
                       "shards": {str(sid): [f"{c:08x}" for c in crcs]
                                  for sid, crcs in sorted(shards.items())}})


def loads(text: str) -> tuple[int, dict[int, list[int]]]:
    doc = json.loads(text)
    return int(doc["block"]), {int(sid): [int(c, 16) for c in crcs]
                               for sid, crcs in doc["shards"].items()}


def entries_wrong(text: str | None, block: int, want: dict[int, list[int]]
                  ) -> int:
    """Entries of the sidecar `text` that differ from `want` (every
    shard's CRCs): a missing, extra or differing CRC counts one, and an
    unreadable sidecar or one of another block size counts them all."""
    total = sum(len(v) for v in want.values())
    if text is None:
        return total
    try:
        got_block, got = loads(text)
    except (ValueError, KeyError, TypeError, AttributeError):
        return total
    if got_block != block:
        return total
    wrong = 0
    for sid in set(want) | set(got):
        a, b = want.get(sid, []), got.get(sid, [])
        wrong += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    return wrong
