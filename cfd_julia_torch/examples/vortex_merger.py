"""Vortex merger with any of the four solver formulations; writes the
vorticity snapshots and, where matplotlib is installed, a contour figure.

    python -m cfd_julia_torch.examples.vortex_merger --solver ps23 --nx 256
                                                     --t 20 [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

from cfd_julia_torch.models import vortex
from cfd_julia_torch.utils import io, plotting


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--solver", default="ps23",
                        choices=["fdm", "hybrid", "ps32", "ps23"])
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("--re", type=float, default=1000.0)
    parser.add_argument("--t", type=float, default=20.0)
    parser.add_argument("--outdir", default="out/vm")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = vortex.VortexConfig(nx=args.nx, ny=args.nx, solver=args.solver,
                              re=args.re, t_final=args.t)
    res = vortex.solve(cfg, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    io.write_vortex_snapshots(args.outdir, res.x, res.y, res.snapshots)
    wmax = float(res.w.abs().max())
    print(f"final |w|max = {wmax:.4f}; snapshots in {args.outdir}/vm*.txt")

    figure = os.path.join(args.outdir, "vm_first.png")
    if plotting.have_matplotlib():
        plotting.field_contours(os.path.join(args.outdir, "vm1.txt"), figure,
                                n_fields=1, titles=("vorticity",))
        print(f"figure: {figure}")
    else:
        print(f"{figure} not written: matplotlib is not installed",
              file=sys.stderr)
        figure = None
    return {"wmax_final": wmax, "figure": figure}


if __name__ == "__main__":
    main()
