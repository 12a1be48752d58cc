"""The cavity step sharded over a 2D mesh of ranks (domain decomposition;
the port's examples/multichip_cavity.py): 64^2, 100 sharded steps from
rest, each rank holding its block of w and psi.

    python -m cfd_julia_torch.examples.multichip_cavity --ranks 4 --device cuda
    python -m cfd_julia_torch.examples.multichip_cavity --ranks 4 --device cpu
    python -m cfd_julia_torch.examples.multichip_cavity --ranks 4 --grad

Several ranks on one GPU share it over gloo, halos staged through host
memory (parallel/launch.py); prints the mesh, the backend and ||dpsi||.
With --grad: fp64 with poisson="fst" and a 0-d tensor Re, and each rank
runs .backward() on the replicated loss 1e6 mean(psi^2); prints
d loss/dRe (every rank holds it) and kernel 1's forward and backward
launches on rank 0 (0 on the CPU, where its plain twin runs).
"""
from __future__ import annotations

import argparse

import torch


def _rank(device, nx: int, steps: int, grad: bool = False) -> dict:
    """One rank: build the mesh and the sharded step, run `steps` steps
    (with grad: fp64, the fst solve, a tensor Re, and the backward)."""
    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.parallel import halo, sharded
    from cfd_julia_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(device.type)
    dtype = torch.float64 if grad else torch.float32
    cfg = cavity.CavityConfig(nx=nx, ny=nx,
                              poisson="fst" if grad else "auto")
    re = torch.tensor(cfg.re, dtype=dtype, device=device,
                      requires_grad=True) if grad else None
    step = sharded.make_sharded_cavity_step(cfg, mesh, dtype, device, re)
    shape = mesh_lib.padded_shape((nx + 1, nx + 1), mesh)
    w0 = sharded.place(torch.zeros(shape, dtype=dtype, device=device), mesh)
    state = (w0, torch.zeros_like(w0), torch.zeros((), dtype=dtype,
                                                   device=device))
    cuda_kernels.reset_launch_counts()
    for _ in range(steps):
        state = step(state)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "transport": halo.transport(mesh, device),
           "block": tuple(state[0].shape), "dpsi": float(state[2]),
           "psi_min": float(sharded.gather(state[1].detach(), mesh).min())}
    if grad:
        loss = 1e6 * halo.all_reduce_sum((state[1] ** 2).sum()) \
            / (nx + 1) ** 2
        forward = cuda_kernels.LAUNCHES["arakawa_rhs"]
        cuda_kernels.reset_launch_counts()
        loss.backward()
        out.update(loss=float(loss), re_grad=float(re.grad),
                   launches=(forward,
                             cuda_kernels.LAUNCHES["arakawa_rhs_backward"]))
    return out


def main(argv=None) -> dict:
    from cfd_julia_torch.parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--grad", action="store_true",
                        help="fp64 with poisson='fst': d(1e6 mean psi^2)/dRe "
                             "through the sharded steps")
    args = parser.parse_args(argv)

    out = launch.run(_rank, args.ranks, args.device,
                     args=(args.nx, args.steps, args.grad))[0]
    print("mesh:", out["mesh"], "block", out["block"])
    print("transport:", out["transport"])
    print(f"{args.steps} sharded steps done; ||dpsi|| = {out['dpsi']:.9g}, "
          f"psi_min = {out['psi_min']:.9g}")
    if args.grad:
        print(f"d(1e6 mean psi^2)/dRe = {out['re_grad']!r} (loss "
              f"{out['loss']!r}); kernel 1 launches on rank 0: "
              f"{out['launches'][0]} forward, {out['launches'][1]} backward")
    return out


if __name__ == "__main__":
    main()
