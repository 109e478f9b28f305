"""CRC32-C (Castagnoli) with seaweedfs's masked `Value()` transform.

weed/storage/needle/crc.go: running CRC32-C, and `Value() = rot17(crc)
+ 0xa282ead8` (the snappy-style mask), which is what lands on disk
after each needle's data.

Backends, fastest first:
1. native C++ (SSE4.2 hardware CRC) via ctypes — utils/native.py;
2. numpy table-driven slice-by-8, far too slow for a full-size volume
   (`native_loaded()` tells callers which one is active).
Both produce identical values; `crc32c()` picks automatically.
"""

from __future__ import annotations

import functools

import numpy as np

CASTAGNOLI_POLY = 0x82F63B78  # reversed representation


def _build_tables(num: int = 8) -> np.ndarray:
    t = np.zeros((num, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (CASTAGNOLI_POLY if crc & 1 else 0)
        t[0, i] = crc
    for k in range(1, num):
        for i in range(256):
            t[k, i] = (t[k - 1, i] >> 8) ^ t[0, t[k - 1, i] & 0xFF]
    return t


_TABLES = _build_tables()


def _crc32c_py(data: bytes | np.ndarray, crc: int = 0) -> int:
    """Slice-by-8 software CRC32-C (update form, pre/post inverted)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.astype(np.uint8, copy=False)
    crc = (~crc) & 0xFFFFFFFF
    n = len(buf)
    i = 0
    t = _TABLES
    main = n - (n % 8)
    if main:
        b = buf[:main].reshape(-1, 8)
        for row in b:
            crc ^= int(row[0]) | int(row[1]) << 8 | int(row[2]) << 16 | \
                int(row[3]) << 24
            crc = (int(t[7, crc & 0xFF]) ^ int(t[6, (crc >> 8) & 0xFF]) ^
                   int(t[5, (crc >> 16) & 0xFF]) ^ int(t[4, (crc >> 24) & 0xFF]) ^
                   int(t[3, row[4]]) ^ int(t[2, row[5]]) ^
                   int(t[1, row[6]]) ^ int(t[0, row[7]]))
        i = main
    while i < n:
        crc = (crc >> 8) ^ int(t[0, (crc ^ int(buf[i])) & 0xFF])
        i += 1
    return (~crc) & 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _native_crc():
    from ..utils import native as native_mod
    lib = native_mod.load()
    if lib is None or not hasattr(lib, "sw_crc32c"):
        return None
    return native_mod.crc32c_fn(lib)


def native_loaded() -> bool:
    """True when crc32c() runs on the native library."""
    return _native_crc() is not None


def crc32c(data: bytes, crc: int = 0) -> int:
    """Running CRC32-C update (matches crc32.Update with Castagnoli table)."""
    fn = _native_crc()
    if fn is not None:
        return fn(data, crc)
    return _crc32c_py(data, crc)


def masked_value(crc: int) -> int:
    """needle.CRC.Value(): rotate-right by 15 then add the snappy constant."""
    crc &= 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


def needle_checksum(data: bytes) -> int:
    """The 4-byte checksum stored after needle data on disk."""
    return masked_value(crc32c(data))
