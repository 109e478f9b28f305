"""ctypes loader for the repository's host-side C++ library (native/).

The library gives the host path its SSE4.2 CRC32-C (`sw_crc32c`), which
every needle checksum and every `.ecc` block CRC on the CPU goes
through, and the GF(2^8) row mix of the `native` coder backend
(`sw_gf_mix`, ops/coder_native.py).  The committed `native/libseaweed_native.so` is tried first;
when it does not load on this host (built elsewhere), the library is
compiled once with `g++ -O3 -shared -fPIC` from
`native/seaweed_native.cpp` into the port's git-ignored build
directory (``seaweedfs_tpu_torch/_build/``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "seaweedfs_tpu_torch", "_build")


def _build_from_source() -> str | None:
    """Compile native/seaweed_native.cpp into BUILD_DIR; None when the
    source or a C++ compiler is missing."""
    src = os.path.join(NATIVE_DIR, "seaweed_native.cpp")
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libseaweed_native-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    committed = os.path.join(NATIVE_DIR, "libseaweed_native.so")
    if os.path.exists(committed):
        try:
            return ctypes.CDLL(committed)
        except OSError:
            pass
    try:
        built = _build_from_source()
    except (OSError, subprocess.CalledProcessError):
        return None
    if built is None:
        return None
    try:
        return ctypes.CDLL(built)
    except OSError:
        return None


def crc32c_fn(lib: ctypes.CDLL):
    """Wrap uint32 sw_crc32c(uint32 crc, const uint8* buf, size_t len)."""
    fn = lib.sw_crc32c
    fn.restype = ctypes.c_uint32
    fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]

    def crc32c(data: bytes, crc: int = 0) -> int:
        return fn(crc, bytes(data), len(data))

    return crc32c


def gf_encode_fn(lib: ctypes.CDLL):
    """Wrap the C++ GF(2^8) row mix (the native coder):

    void sw_gf_mix(const uint8* mat, int rows, int cols,
                   const uint8* const* shards_in, uint8** shards_out,
                   size_t n)
    """
    fn = lib.sw_gf_mix
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
    return fn
