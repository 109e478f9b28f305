"""ErasureCoder backend selection.

Backends, byte-identical to each other and to seaweedfs_tpu's:

- "cuda":   the GF(2) bit-matrix kernels of `coder_cuda.py` on a CUDA
            device; with ``device="cpu"`` the same coder runs the
            kernels' plain PyTorch versions;
- "torch":  the bit-matrix product as plain torch matmuls
            (`coder_torch.py`) on the caller's device;
- "native": the repository's C++ row mix (`coder_native.py`; host only,
            needs native/libseaweed_native.so);
- "numpy":  the table-lookup oracle (host only).

Selection: the `backend` argument, else the SEAWEEDFS_TORCH_CODER
environment variable, else "cuda".  The device is always the caller's
``device=`` (default ``"cuda"``, which raises without a card); the
host-only backends take ``device="cpu"``.

Every backend shares one API: encode / encode_all / reconstruct /
verify on (shards, n) uint8 rows.  The cuda and torch backends return
tensors on their device; `host_array` brings any backend's result to
the host.
"""

from __future__ import annotations

import os
from typing import Protocol

import numpy as np
import torch

from ..stats import roofline


class ErasureCoder(Protocol):
    data_shards: int
    parity_shards: int
    total_shards: int

    def encode(self, data): ...
    def encode_all(self, data): ...
    def reconstruct(self, shards: dict, wanted: list[int] | None = None
                    ) -> dict: ...
    def verify(self, shards) -> bool: ...


_BACKENDS = ("cuda", "torch", "native", "numpy")

# The backend chosen when neither the caller nor the environment names one.
ENV_CODER = "SEAWEEDFS_TORCH_CODER"


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when it names CUDA and no
    card is available (never a silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the kernels' plain PyTorch versions")
    return dev


def host_array(x) -> np.ndarray:
    """A coder result (tensor on any device, or numpy) as a host array.
    The copy waits for the launches before it on the result's stream,
    so their roofline timings are settled here too."""
    if isinstance(x, torch.Tensor):
        out = x.cpu().numpy()
        if x.device.type == "cuda":
            roofline.settle()
        return out
    return np.asarray(x)


def default_backend() -> str:
    """SEAWEEDFS_TORCH_CODER when set (one of the backends), else cuda."""
    env = os.environ.get(ENV_CODER)
    if env:
        if env not in _BACKENDS:
            raise ValueError(f"{ENV_CODER}={env!r}; expected one of {_BACKENDS}")
        return env
    return "cuda"


def _host_only(backend: str, device) -> None:
    if resolve_device(device).type != "cpu":
        raise ValueError(f"the {backend} backend runs on the host; "
                         "pass device='cpu'")


def new_coder(data_shards: int = 10, parity_shards: int = 4,
              matrix_kind: str = "vandermonde", backend: str | None = None,
              codec=None, device="cuda") -> ErasureCoder:
    """Build a coder.  `codec` (a registered codec name or Codec object)
    overrides the RS shard-count arguments: the codec is the scheme, the
    backend only where the byte mix runs."""
    backend = backend or default_backend()
    if backend == "numpy":
        _host_only(backend, device)
        from .coder_numpy import NumpyCoder
        return NumpyCoder(data_shards, parity_shards, matrix_kind, codec)
    if backend == "native":
        _host_only(backend, device)
        from .coder_native import NativeCoder
        return NativeCoder(data_shards, parity_shards, matrix_kind, codec)
    if backend == "torch":
        from .coder_torch import TorchCoder
        return TorchCoder(data_shards, parity_shards, matrix_kind,
                          codec=codec, device=device)
    if backend == "cuda":
        from .coder_cuda import CudaCoder
        return CudaCoder(data_shards, parity_shards, matrix_kind,
                         codec=codec, device=device)
    raise ValueError(f"unknown erasure backend {backend!r}; "
                     f"expected one of {_BACKENDS}")
