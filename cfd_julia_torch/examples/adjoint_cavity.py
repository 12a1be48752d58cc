"""Adjoint sensitivity of the lid-driven cavity to the Reynolds number.

The cavity step (RK3, wall BCs, the DST Poisson solve) takes Re as a 0-d
tensor; torch.autograd follows the eager loop (loop.advance with
graph=False), so one backward pass gives d(loss)/d(Re).  On a GPU the
RHS is kernel 1 (csrc/arakawa_rhs.cu) and its backward kernel.  The run
is in fp64 so the gradient can be held against a central difference.

    python -m cfd_julia_torch.examples.adjoint_cavity [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity
from cfd_julia_torch.stepping import loop

NX, STEPS, DT = 32, 100, 1e-3
FD_STEP = 0.5      # central-difference step in Re


def loss(re, device, dtype=torch.float64):
    """Mean-square streamfunction after STEPS steps from rest, as a
    function of a 0-d Re tensor (make_step_fn's re: the production step,
    not a re-implementation)."""
    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=DT)
    step = cavity.make_step_fn(cfg, dtype, device, re=re)
    final = loop.advance(step, cavity.initial_state(cfg, dtype, device),
                         STEPS, graph=False)
    return 1e6 * torch.mean(final[1] ** 2)


def grad(re_value: float, device):
    """(loss, d loss / d Re) at re_value, by one backward pass."""
    re = torch.tensor(re_value, dtype=torch.float64, device=device,
                      requires_grad=True)
    val = loss(re, device)
    (g,) = torch.autograd.grad(val, re)
    return float(val.detach()), float(g)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = precision.resolve_device(args.device)

    val, g = grad(100.0, dev)
    print(f"loss(Re=100)      = {val:.6f}")
    print(f"d loss / d Re     = {g:.6e}")
    with torch.no_grad():
        fd = (float(loss(torch.tensor(100.0 + FD_STEP, dtype=torch.float64,
                                      device=dev), dev))
              - float(loss(torch.tensor(100.0 - FD_STEP,
                                        dtype=torch.float64, device=dev),
                           dev))) / (2 * FD_STEP)
    rel = abs(g - fd) / abs(fd)
    print(f"central difference (h={FD_STEP:g}) = {fd:.6e}  (rel {rel:.2e})")
    grads = {}
    for r in (50.0, 100.0, 200.0):
        grads[r] = grad(r, dev)[1]
        print(f"d loss / d Re @ Re={r:5.0f} : {grads[r]:.6e}")
    return {"loss": val, "grad": g, "fd": fd, "fd_rel": rel,
            "grads": grads}


if __name__ == "__main__":
    main()
