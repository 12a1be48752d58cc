"""Run the lid-driven cavity to steady state and compare against the
Ghia et al. (1982) benchmark centerlines.

    python -m cfd_julia_torch.examples.cavity_ghia [--nx 64] [--re 100]
                                                   [--t 10] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from cfd_julia_torch.models import cavity

GHIA_Y = [0.0547, 0.1719, 0.4531, 0.5, 0.8516, 0.9531]
GHIA_U = [-0.03717, -0.10150, -0.21090, -0.20581, 0.23151, 0.68717]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--re", type=float, default=100.0)
    parser.add_argument("--t", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = cavity.CavityConfig(nx=args.nx, ny=args.nx, re=args.re,
                              t_final=args.t)
    res = cavity.solve(cfg, device=args.device)
    u, v = cavity.centerline_velocities(res, cfg)

    rms = float(res.rms_history[-1])
    psi_min = float(res.s.min())
    print(f"steady-state ||dpsi||: {rms:.3e}")
    print(f"psi_min: {psi_min:.6f} (Ghia Re=100: -0.103423)")
    y = np.linspace(0, 1, cfg.ny + 1)
    ui = np.interp(GHIA_Y, y, u.double().cpu().numpy())
    for yy, ug, un in zip(GHIA_Y, GHIA_U, ui):
        print(f"  y={yy:.4f}  ghia={ug:+.5f}  ours={un:+.5f}")
    return {"steady_rms": rms, "psi_min": psi_min,
            "max_u_dev": float(np.abs(ui - np.asarray(GHIA_U)).max())}


if __name__ == "__main__":
    main()
