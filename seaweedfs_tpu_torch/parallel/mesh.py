"""Device meshes for the batched EC steps.

Port of seaweedfs_tpu/parallel/mesh.py.  A mesh is a (vol, col) grid of
`torch.device`s:

- "vol": data-parallel over volumes (batched encode and rebuild);
- "col": byte columns of a volume split across devices.

Every codec's parity and CRCs are columnwise, so a (V, R, N) batch splits
into one block per device — volumes over "vol", columns over "col" —
with no bytes moving between devices (`volume_blocks`).  A result laid
out that way is a `MeshArray`, the counterpart of a jax.Array sharded
by `volume_sharding`; `np.asarray` gathers it on the host.

The multi-card reconstructions (`sharded_codec.all_to_all_reconstruct`,
`ring_reconstruct`) run one process per card over `torch.distributed`
instead of one grid: their survivor stacks are split by shard rows over
the ranks (`shard_row_block`, the counterpart of `shard_row_sharding`).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (vol, col) grid of devices; `shape` maps axis name to size, as
    jax.sharding.Mesh's does."""

    def __init__(self, grid):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.devices = tuple(tuple(r) for r in rows)
        self.shape = {"vol": len(rows), "col": len(rows[0])}

    def device_list(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]


def make_mesh(n_devices: int | None = None, vol_axis: int | None = None,
              devices=None) -> Mesh:
    """A (vol_axis, n // vol_axis) mesh over `devices` (default: every
    visible CUDA device; raises when there is none).  Volume parallelism
    is favoured: vol_axis defaults to the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the mesh; pass devices="
                "[torch.device('cpu'), ...] to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    devices = devices[:n]
    if vol_axis is None:
        vol_axis = n
    if n % vol_axis:
        raise ValueError(f"{n} devices do not split into vol axis {vol_axis}")
    col_axis = n // vol_axis
    return Mesh([devices[i * col_axis:(i + 1) * col_axis]
                 for i in range(vol_axis)])


def volume_blocks(mesh: Mesh, v: int, n: int
                  ) -> list[tuple[int, int, torch.device, slice, slice]]:
    """(vol index, col index, device, volume slice, column slice) of each
    device's block of a (v, R, n) batch: volumes over "vol", columns over
    "col" (both must divide)."""
    vl, nl = v // mesh.shape["vol"], n // mesh.shape["col"]
    return [(vi, ci, dev, slice(vi * vl, (vi + 1) * vl),
             slice(ci * nl, (ci + 1) * nl))
            for vi, row in enumerate(mesh.devices)
            for ci, dev in enumerate(row)]


class MeshArray:
    """A (V, R, N) array held as one tensor per device of a mesh,
    `blocks[(vi, ci)]` covering the volume_blocks slices.  `np.asarray`
    (or `numpy()`) copies every block to the host and assembles it."""

    def __init__(self, mesh: Mesh, blocks: dict, shape: tuple[int, ...]):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(shape)
        self.dtype = next(iter(blocks.values())).dtype

    def numpy(self) -> np.ndarray:
        v, _r, n = self.shape
        out = np.empty(self.shape, dtype=torch.empty(
            0, dtype=self.dtype).numpy().dtype)
        for vi, ci, _dev, vs, cs in volume_blocks(self.mesh, v, n):
            out[vs, :, cs] = self.blocks[(vi, ci)].cpu().numpy()
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def shard_row_block(stacked, rank: int, world: int):
    """Rank `rank`'s block of a (V, S, N) survivor stack whose shard rows
    S are split over `world` ranks: rows [rank*S/world, (rank+1)*S/world),
    whole shards, as hosts hold them in the cluster.  The counterpart of
    the JAX package's `shard_row_sharding` (P("vol", "col", None) with
    the ranks as the "col" axis)."""
    rows = stacked.shape[1] // world
    return stacked[:, rank * rows:(rank + 1) * rows, :]
