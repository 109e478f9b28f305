"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

This slice carries the Reed-Solomon RS(10,4) erasure-coding data path:
`.dat` -> `.ec00`-`.ec13` + `.ecx` + `.ecc` (``ec/encoder.py``), shard
rebuild, and the degraded needle read (``ec/volume.py``).  The GF(2^8)
byte mix and the fused `.ecc` CRC32-C run in two hand-written CUDA
kernels for Hopper (``csrc/``, bound in ``ops/coder_cuda.py``).  In
front of it sit the storage engine (``storage/``), the control plane
(``cluster/rpc.py``, ``cluster/master.py``, ``topology/``, ``tenancy/``,
``netcore/``), the volume server and client (``cluster/volume_server.py``,
``cluster/client.py``) and the admin shell (``shell/``): ``python -m
seaweedfs_tpu_torch master``, ``volume`` and ``shell`` form a cluster.

The package imports torch, numpy and the standard library only.  Module
paths follow ``seaweedfs_tpu/`` so each counterpart is found by name;
the on-disk formats are the same, so either package opens the other's
files.  Entry points take ``device=`` (default ``"cuda"``) and raise
when no card is present; pass ``device="cpu"`` to run the kernels'
plain PyTorch versions.
"""

__version__ = "0.1.0"
