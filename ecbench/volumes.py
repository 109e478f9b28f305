"""The inputs of a cell, made from --seed on the card: a volume's `.dat`
and `.idx`.  Every stream is drawn from a generator seeded by (seed,
stream, volume), so the same seed gives the same inputs."""

from __future__ import annotations

import numpy as np
import torch

# Columns of shards the judge and the control work on at a time.
PIECE_COLS = 16 << 20

SUPERBLOCK = bytes([3, 0, 0, 0, 0, 0, 0, 0])  # version 3, "000", no TTL
HEADER = 16       # cookie u32, id u64, size u32
FOOTER = 4 + 8    # checksum u32, append_at_ns u64 (version 3)
PADDING = 8


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for one stream of one run's seed."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def random_bytes(n: int, seed: int, stream: tuple, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, *stream))
    return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g,
                         device=device)


def needle_sizes(rng: np.random.Generator, params: dict, room: int
                 ) -> list[int]:
    """Payload sizes, log-normal from the configuration's parameters,
    until the next record would pass `room` bytes."""
    out, used = [], len(SUPERBLOCK)
    mu = np.log(params["median_bytes"])
    while True:
        size = int(np.clip(np.exp(rng.normal(mu, params["sigma"])),
                           params["min_bytes"], params["max_bytes"]))
        rec = record_bytes(size)
        if used + rec > room:
            return out
        out.append(size)
        used += rec


def record_bytes(payload: int) -> int:
    """On-disk bytes of a version-3 needle record of one payload: header,
    body (data size u32, data, flags u8), footer, 1 to 8 padding bytes."""
    body = 4 + payload + 1
    return HEADER + body + FOOTER + \
        PADDING - (HEADER + body + FOOTER) % PADDING


def make_volume(seed: int, volume: int, room: int, params: dict, device
                ) -> tuple[torch.Tensor, bytes]:
    """A `.dat` of needles filling at most `room` bytes, on the card, and
    its `.idx`.  Keys rise with gaps, as a master's sequence hands them
    out, and arrive a little out of order (shuffled in windows of 16);
    payloads are random bytes; needle checksums are left 0, as no cell
    reads a needle."""
    rng = host_rng(seed, 2, volume)
    sizes = needle_sizes(rng, params, room)
    n = len(sizes)
    keys = (1 << 32) * (volume + 1) + np.cumsum(rng.integers(1, 9, n))
    for lo in range(0, n, 16):
        rng.shuffle(keys[lo:lo + 16])
    cookies = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    offsets, pos, vals = [], [], []
    at = len(SUPERBLOCK)
    for i, payload in enumerate(sizes):
        offsets.append(at)
        body = 4 + payload + 1
        head = (int(cookies[i]).to_bytes(4, "big")
                + int(keys[i]).to_bytes(8, "big")
                + body.to_bytes(4, "big") + payload.to_bytes(4, "big"))
        rec = record_bytes(payload)
        tail = bytes(1 + 4) + (i + 1).to_bytes(8, "big")
        tail += bytes(rec - HEADER - 4 - payload - len(tail))
        pos += [range(at, at + len(head)),
                range(at + len(head) + payload, at + rec)]
        vals += [head, tail]
        at += rec
    dat = random_bytes(at, seed, (3, volume), device)
    dat[:len(SUPERBLOCK)] = torch.tensor(list(SUPERBLOCK), dtype=torch.uint8)
    index = torch.from_numpy(np.concatenate(
        [np.arange(r.start, r.stop, dtype=np.int64) for r in pos]))
    dat[index.to(dat.device)] = torch.frombuffer(
        bytearray(b"".join(vals)), dtype=torch.uint8).to(dat.device)
    idx = np.zeros(n, dtype=[("key", ">u8"), ("offset", ">u4"),
                             ("size", ">u4")])
    idx["key"] = keys
    idx["offset"] = np.array(offsets) // PADDING
    idx["size"] = [4 + s + 1 for s in sizes]
    return dat, idx.tobytes()
