"""Spawned ranks for the port's X4 tests: each rank joins a gloo group
on localhost, runs `all_to_all_reconstruct` or `ring_reconstruct` of
`seaweedfs_tpu_torch.parallel.sharded_codec` on a CPU tensor (the
kernel's plain version), and writes what it got.  Imports torch, numpy
and the port only, so the ranks start without JAX.  The ranks' gloo
store listens on a port below the ephemeral range, from this xdist
worker's slice (`_torch_cluster.grpc_pair_port`): a port picked by
binding port 0 is free only until some connection of another worker
takes it as its source port."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, port: int, fn_name: str, case: str,
          out_dir: str) -> None:
    from seaweedfs_tpu_torch.parallel import sharded_codec as sc
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        z = np.load(case)
        present, wanted = tuple(z["present"]), tuple(z["wanted"])
        try:
            local = getattr(sc, fn_name)(torch.from_numpy(z["stacked"]),
                                         present, wanted, device="cpu")
        except ValueError as e:
            with open(os.path.join(out_dir, f"err{rank}.txt"), "w") as f:
                f.write(str(e))
            return
        got = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(got, local)
        whole = torch.cat(got, dim=2)  # rank order is column order
        np.save(os.path.join(out_dir, f"local{rank}.npy"), local.numpy())
        np.save(os.path.join(out_dir, f"whole{rank}.npy"), whole.numpy())
    finally:
        dist.destroy_process_group()


def run(fn_name: str, world: int, stacked: np.ndarray, present, wanted,
        out_dir) -> dict:
    """Run `fn_name` on `world` spawned gloo ranks.  Returns
    {"local": [each rank's column block], "whole": [each rank's gathered
    output]} or {"errors": [each rank's ValueError message]}."""
    from _torch_cluster import grpc_pair_port
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    case = os.path.join(out_dir, "case.npz")
    np.savez(case, stacked=stacked, present=np.asarray(present),
             wanted=np.asarray(wanted))
    mp.spawn(_rank, args=(world, grpc_pair_port(), fn_name, case, out_dir),
             nprocs=world, join=True)
    errs = [os.path.join(out_dir, f"err{r}.txt") for r in range(world)]
    if any(os.path.exists(e) for e in errs):
        return {"errors": [open(e).read() if os.path.exists(e) else None
                           for e in errs]}
    return {k: [np.load(os.path.join(out_dir, f"{k}{r}.npy"))
                for r in range(world)] for k in ("local", "whole")}
