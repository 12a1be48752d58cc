"""The cavity step sharded over a 2D mesh of ranks (domain decomposition;
the port's examples/multichip_cavity.py): 64^2, 100 sharded steps from
rest, each rank holding its block of w and psi.

    python -m cfd_julia_torch.examples.multichip_cavity --ranks 4 --device cuda
    python -m cfd_julia_torch.examples.multichip_cavity --ranks 4 --device cpu

Several ranks on one GPU share it over gloo, halos staged through host
memory (parallel/launch.py); prints the mesh, the backend and ||dpsi||.
"""
from __future__ import annotations

import argparse

import torch


def _rank(device, nx: int, steps: int) -> dict:
    """One rank: build the mesh and the sharded step, run `steps` steps."""
    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.parallel import halo, sharded
    from cfd_julia_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(device.type)
    cfg = cavity.CavityConfig(nx=nx, ny=nx)
    step = sharded.make_sharded_cavity_step(cfg, mesh, torch.float32, device)
    shape = mesh_lib.padded_shape((nx + 1, nx + 1), mesh)
    w0 = sharded.place(torch.zeros(shape, device=device), mesh)
    state = (w0, torch.zeros_like(w0), torch.zeros((), device=device))
    for _ in range(steps):
        state = step(state)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "transport": halo.transport(mesh, device),
            "block": tuple(state[0].shape), "dpsi": float(state[2]),
            "psi_min": float(sharded.gather(state[1], mesh).min())}


def main(argv=None) -> dict:
    from cfd_julia_torch.parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args(argv)

    out = launch.run(_rank, args.ranks, args.device,
                     args=(args.nx, args.steps))[0]
    print("mesh:", out["mesh"], "block", out["block"])
    print("transport:", out["transport"])
    print(f"{args.steps} sharded steps done; ||dpsi|| = {out['dpsi']:.9g}, "
          f"psi_min = {out['psi_min']:.9g}")
    return out


if __name__ == "__main__":
    main()
