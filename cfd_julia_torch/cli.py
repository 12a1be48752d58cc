"""Command-line interface (counterpart of cfd_julia_tpu/cli.py).

    python -m cfd_julia_torch list
    python -m cfd_julia_torch run <preset> [--outdir DIR] [--device cuda|cpu]
                                  [--checkpoint-every N] [--resume]
                                  [--sweep FIELD=V1,V2[;FIELD2=...]]
                                  [--nx N] [--t_final X] ...
    python -m cfd_julia_torch validate [--device cuda|cpu]
    python -m cfd_julia_torch run-all [--full] [--outdir DIR] [--device ...]
    python -m cfd_julia_torch order {heat,burgers,poisson} [--scheme S]
                                    [--grids 32,64,...] [--self] [--bc BC]
                                    [--outdir DIR] [--device ...]
    python -m cfd_julia_torch plot RUNDIR [--true-dir DIR]

`run` accepts any config dataclass field of the preset as a --key value
override, e.g. `run cavity --poisson fused_bf16x3` for a precision tier of
the cavity's Poisson products (matmul_bf16x3 | matmul_bf16x1 |
fused_bf16x3 | fused_bf16x1: the TPU's split-bf16 arithmetic on every
device, the CUDA kernel on a GPU and its plain twin on the CPU; fp32, the
runs' default dtype).  Every subcommand that computes takes --device,
which defaults to cuda and raises without a GPU; a CPU run says
--device cpu.  `order` runs in fp64 on its device (the H100 runs fp64
natively).  `plot` needs matplotlib; `order` without it still writes its
numbers and says on stderr which figure it left out.  The JAX CLI's
`bench` belongs to the benchmark harness and is not here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _parse_value(field_type, raw: str):
    """Parse a CLI override honoring the declared dataclass field type
    (string annotations under `from __future__ import annotations`):
    a str-typed field keeps "32" as a string, an int/float field parses
    numerically; untyped falls back to inference."""
    tname = field_type if isinstance(field_type, str) else \
        getattr(field_type, "__name__", "")
    if tname == "str":
        return raw
    if tname == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if tname == "int":
        try:
            return int(raw)
        except ValueError:
            f = float(raw)         # accept integral "1e5" / "2.0"
            if f != int(f):
                raise ValueError(
                    f"{raw!r} is not an integer value") from None
            return int(f)
    if tname == "float":
        return float(raw)
    for cast in (int, float):
        try:
            v = cast(raw)
            if cast is int and "." in raw:
                continue
            return v
        except ValueError:
            continue
    return raw


def cmd_list(_args):
    from cfd_julia_torch import presets

    for name in sorted(presets.PRESETS):
        p = presets.PRESETS[name]
        print(f"{name:28s} [{p.family:8s}] {p.reference}")
        if p.description:
            print(f"{'':28s}   {p.description}")
    return 0


def _sweep_suffix(pt: dict) -> str:
    """The suffix of a sweep point's alias files in the top outdir: the
    bare grid value(s) for an nx/ny sweep (output_$nx.txt, as the
    reference's fft_p.jl:110 and weno_dirichlet.jl:158 name them), else
    key and value (output_re100.txt) so no alias collides with a grid
    suffix."""
    if set(pt) <= {"nx", "ny"}:
        vals = [str(v) for v in pt.values()]
        return vals[0] if len(set(vals)) == 1 else "_".join(vals)
    return "_".join(f"{k}{v}" for k, v in pt.items())


def _run_sweep(args, fields, overrides):
    """One run per point of --sweep FIELD=V1,V2[;FIELD2=...] (fields zip
    together), each in its own subdirectory (several runners write
    fixed-name files that a shared outdir would clobber), the reference-
    style per-grid aliases in the top outdir, and sweep_metrics.json."""
    import shutil

    from cfd_julia_torch import run

    if args.checkpoint_every or args.resume:
        print("--checkpoint-every/--resume do not combine with "
              "--sweep (per-point runs are short)", file=sys.stderr)
        return 2
    sweep = {}
    for part in args.sweep.split(";"):
        key, _, raw = part.partition("=")
        if key not in fields or not raw:
            print(f"--sweep wants field=v1,v2[;field2=...] with "
                  f"{args.preset} fields; fields: {', '.join(fields)}",
                  file=sys.stderr)
            return 2
        sweep[key] = [_parse_value(fields[key].type, v)
                      for v in raw.split(",")]
    if len({len(v) for v in sweep.values()}) != 1:
        print("--sweep fields must have equal value counts", file=sys.stderr)
        return 2
    all_metrics = []
    for point in zip(*sweep.values()):
        pt = dict(zip(sweep.keys(), point))
        sub = "/".join([args.outdir,
                        "_".join(f"{k}{v}" for k, v in pt.items())])
        m = run.run_preset(args.preset, outdir=sub, device=args.device,
                           **{**overrides, **pt})
        m.update(pt)
        all_metrics.append(m)
        suffix = _sweep_suffix(pt)
        for fn in sorted(os.listdir(sub)):
            base, ext = os.path.splitext(fn)
            if ext in (".txt", ".csv") and base.startswith(
                    ("solution", "output", "field_final")):
                if not base.endswith("_" + suffix):  # some writers
                    base = f"{base}_{suffix}"  # already embed the size
                shutil.copyfile(os.path.join(sub, fn),
                                os.path.join(args.outdir, base + ext))
    with open(f"{args.outdir}/sweep_metrics.json", "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(json.dumps(all_metrics, indent=2))
    return 0


def cmd_run(args, extra):
    from cfd_julia_torch import presets, run

    preset = presets.get(args.preset)
    overrides = {}
    fields = {f.name: f for f in dataclasses.fields(preset.cfg)}
    i = 0
    while i < len(extra):
        key = extra[i].lstrip("-")
        if key not in fields:
            print(f"unknown override --{key} for preset {args.preset}; "
                  f"fields: {', '.join(fields)}", file=sys.stderr)
            return 2
        if i + 1 >= len(extra):
            print(f"override --{key} needs a value", file=sys.stderr)
            return 2
        try:
            overrides[key] = _parse_value(fields[key].type, extra[i + 1])
        except ValueError as e:
            print(f"override --{key}: {e}", file=sys.stderr)
            return 2
        i += 2

    if args.sweep:
        return _run_sweep(args, fields, overrides)
    metrics = run.run_preset(args.preset, outdir=args.outdir,
                             device=args.device,
                             checkpoint_every=args.checkpoint_every,
                             resume=args.resume, **overrides)
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_validate(args):
    """Quick validation sweep: one representative run per family, in the
    default fp32 on --device, with the JAX CLI's checks and tolerances."""
    import numpy as np

    from cfd_julia_torch.core import precision
    from cfd_julia_torch.models import (burgers1d, cavity, euler1d, heat1d,
                                        poisson2d, vortex)

    dev = precision.resolve_device(args.device)
    ok = True

    def check(name, value, tol):
        nonlocal ok
        good = value < tol
        ok &= good
        print(f"{'PASS' if good else 'FAIL'} {name}: {value:.3e} (tol {tol:g})")

    def host(t):
        return t.double().cpu().numpy()

    r = heat1d.solve(heat1d.HeatConfig(scheme="icp"), device=dev)
    check("heat icp L2", float(r.l2_error), 1e-5)
    rb = burgers1d.solve(burgers1d.BurgersConfig(nx=200, t_final=0.25),
                         device=dev)
    u0, uf = host(rb.snapshots[0]), host(rb.u)
    tv = lambda a: np.abs(np.diff(np.append(a, a[0]))).sum()
    # WENO is essentially non-oscillatory: total variation must not grow
    # through the shock (a much stronger property than boundedness)
    check("burgers weno TV growth", float(tv(uf) - tv(u0)), 0.01)
    rbc = burgers1d.solve(burgers1d.BurgersConfig(nx=200, t_final=0.25,
                                                  solver="rusanov"),
                          device=dev)
    # conservative (flux-form) solver: cell mean is conserved to roundoff
    drift = abs(float(host(rbc.u).mean()) - float(host(rbc.snapshots[0])
                                                   .mean()))
    check("burgers rusanov mass drift", drift, 1e-5)
    re_ = euler1d.solve(euler1d.EulerConfig(nx=256), device=dev)
    check("euler sod rho positivity", float(-(host(re_.q[0]).min())),
          0.0 + 1e-12)
    rp = poisson2d.solve(poisson2d.PoissonConfig(nx=64, ny=64,
                                                 solver="multigrid",
                                                 problem="poly"), device=dev)
    check("poisson mg error", float(rp.linf_error), 1e-5)
    rc = cavity.solve(cavity.CavityConfig(t_final=2.0), device=dev)
    check("cavity steady progress", float(rc.rms_history[-1]), 1e-4)
    cfgv = vortex.VortexConfig(nx=64, ny=64, solver="ps23", dt=0.01,
                               t_final=1.0, re=10.0, ic="tgv", ns=1)
    rv = vortex.solve(cfgv, device=dev)
    check("tgv spectral L2", float(vortex.tgv_error(cfgv, rv)[0]), 1e-4)
    print("validate:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


# run-all's reduced settings for the heavy presets (without --full), the
# JAX CLI's table
QUICK = {
    "burgers_crweno_dirichlet": {"nx": 400},
    "burgers_crweno_periodic": {"nx": 400},
    "euler_hllc": {"nx": 1024, "dt": 2e-4},
    "euler_rusanov": {"nx": 1024, "dt": 2e-4},
    "poisson_jacobi": {"nx": 128, "ny": 128, "max_iter": 200_000},
    "poisson_gs_redblack": {"nx": 128, "ny": 128, "max_iter": 200_000},
    "poisson_cg": {"nx": 256, "ny": 256},
    "cavity": {"t_final": 2.0},
    "vortex_merger_fdm": {"t_final": 4.0},
    "vortex_merger_hybrid": {"t_final": 4.0},
    "vortex_merger_ps32": {"t_final": 4.0},
    "vortex_merger_ps23": {"t_final": 4.0},
}


def cmd_run_all(args):
    """run.sh parity: execute every preset (scaled down unless --full).
    A failing preset is reported (its traceback on stderr) and the rest
    still run; the exit code is 1 if any failed."""
    import traceback

    from cfd_julia_torch import presets, run
    from cfd_julia_torch.core import precision

    precision.resolve_device(args.device)   # no GPU: raise, not 29 FAILs
    failures = []
    for name in sorted(presets.PRESETS):
        overrides = {} if args.full else QUICK.get(name, {})
        outdir = os.path.join(args.outdir, name)
        try:
            m = run.run_preset(name, outdir=outdir, device=args.device,
                               **overrides)
            print(f"OK   {name:28s} {m.get('wall_time_s', 0):.2f}s")
        except Exception as e:  # keep going, report at the end
            failures.append((name, str(e)))
            traceback.print_exc()
            print(f"FAIL {name:28s} {e}")
    print(f"run-all: {len(presets.PRESETS) - len(failures)}/"
          f"{len(presets.PRESETS)} presets OK")
    return 1 if failures else 0


def _interp_1d(xc, xf, uf):
    """Gridded linear interpolation of a fine-grid solution onto coarse
    nodes (06_.../order.jl:24-27 interp_grid). For nested node grids the
    coarse nodes coincide with fine nodes and this is exact subsampling."""
    import numpy as np

    return np.interp(np.asarray(xc), np.asarray(xf), np.asarray(uf))


def _interp_2d(xc, yc, xf, yf, U):
    """Bilinear regular-grid interpolation (2D analogue of interp_grid)
    via one axis at a time with precomputed weights."""
    import numpy as np

    U = np.asarray(U)

    def along0(coords_c, coords_f, A):
        cf = np.asarray(coords_f)
        i = np.clip(np.searchsorted(cf, coords_c) - 1, 0, len(cf) - 2)
        w = (np.asarray(coords_c) - cf[i]) / (cf[i + 1] - cf[i])
        w = np.clip(w, 0.0, 1.0)[:, None] if A.ndim == 2 else np.clip(w, 0, 1)
        return A[i] * (1 - w) + A[i + 1] * w

    return along0(yc, yf, along0(xc, xf, U).T).T


_ORDER_DEFAULT_SCHEMES = {"heat": "cn", "burgers": "weno",
                          "poisson": "fft"}


def _order_fields(args, ns):
    """Per-grid (coords, u, exact_err) for the order studies, each solve in
    fp64 on args.device, its fields brought to the host as numpy.

    exact_err is None when no closed-form solution applies (dirichlet
    Burgers) — the --self grid-pair mode needs none."""
    import numpy as np
    import torch

    if not args.scheme:
        # the ONE defaults table, filled here so CLI and direct callers
        # share it
        args.scheme = _ORDER_DEFAULT_SCHEMES[args.family]
    f64, dev = torch.float64, args.device

    def host(t):
        return t.cpu().numpy()

    out = []
    if args.family == "heat":
        from cfd_julia_torch.models import heat1d

        for n in ns:
            cfg = heat1d.HeatConfig(nx=n, dt=min(0.0025, 0.1 / n**2),
                                    t_final=0.1, scheme=args.scheme)
            res = heat1d.solve(cfg, f64, dev)
            out.append((host(res.x), host(res.u), float(res.l2_error)))
    elif args.family == "poisson":
        from cfd_julia_torch.models import poisson2d

        for n in ns:
            cfg = poisson2d.PoissonConfig(nx=n, ny=n, solver=args.scheme,
                                          problem="sine32")
            res = poisson2d.solve(cfg, f64, dev)
            out.append(((host(res.x), host(res.y)), host(res.u),
                        float(res.l2_error)))
    elif args.family == "burgers":
        from cfd_julia_torch.models import burgers1d

        bc = getattr(args, "bc", "periodic")
        for n in ns:
            cfg = burgers1d.BurgersConfig(nx=n, solver=args.scheme,
                                          bc=bc, dt=5e-5,
                                          t_final=0.05, ns=1)
            res = burgers1d.solve(cfg, f64, dev)
            x = host(res.x)
            err = None
            if bc == "periodic":
                u = np.sin(2 * np.pi * x)
                for _ in range(60):
                    u = np.sin(2 * np.pi * (x - u * 0.05))
                err = float(np.sqrt(np.mean((host(res.u) - u) ** 2)))
            out.append((x, host(res.u), err))
    else:
        return None
    return out


def _self_convergence(ns, fields):
    """Grid-pair self-convergence: no exact solution needed
    (06_.../order.jl:53-75). For each consecutive grid triplet
    (coarse, mid, fine) interpolate the two finer solutions onto the
    coarse coordinates and form
        e1 = |u_c - I(u_m)|,  e2 = |I(u_m) - I(u_f)|,
        p  = log(e1/e2) / log(n_m/n_c)
    in the 1-, 2- and inf-norms (the reference's `for ord in (1,2,Inf)`).

    Returns rows of (n_c, n_m, n_f, norm_name, e1, e2, p)."""
    import numpy as np

    rows = []
    for i in range(len(ns) - 2):
        (cc, uc, _), (cm, um, _), (cf, uf, _) = fields[i:i + 3]
        beta = ns[i + 1] / ns[i]
        if isinstance(cc, tuple):  # 2D regular grid
            um_i = _interp_2d(cc[0], cc[1], cm[0], cm[1], um)
            uf_i = _interp_2d(cc[0], cc[1], cf[0], cf[1], uf)
        else:
            um_i = _interp_1d(cc, cm, um)
            uf_i = _interp_1d(cc, cf, uf)
        d1 = (uc - um_i).ravel()
        d2 = (um_i - uf_i).ravel()
        for name, ordv in (("1", 1), ("2", 2), ("inf", np.inf)):
            e1 = float(np.linalg.norm(d1, ordv))
            e2 = float(np.linalg.norm(d2, ordv))
            p = float(np.log(e1 / e2) / np.log(beta)) if e1 > 0 and e2 > 0 \
                else float("nan")
            rows.append((ns[i], ns[i + 1], ns[i + 2], name, e1, e2, p))
    return rows


def _order_figure(path, ns, errs, slope_guides):
    """The study's log-log figure, or a line on stderr where matplotlib is
    not installed: the numbers, already written, are the result."""
    from cfd_julia_torch.utils import plotting

    if not plotting.have_matplotlib():
        print(f"{os.path.basename(path)} not written: matplotlib is not "
              "installed", file=sys.stderr)
        return
    plotting.convergence_order(ns, errs, path, slope_guides=slope_guides)


def cmd_order(args):
    """Convergence-order study (06_.../order.jl, 13_.../order.jl), in fp64
    on args.device (the solves' errors reach ~1e-10, below fp32's floor).

    Default mode measures error against the exact solution; --self runs
    the reference's grid-pair study instead (interpolated error ratios
    between consecutive grids, no exact solution required).  The text
    file and the printed table come first, then the figure."""
    from cfd_julia_torch.core import precision
    from cfd_julia_torch.utils import plotting

    ns = [int(v) for v in args.grids.split(",")]
    if args.self_pairs and len(ns) < 3:
        # argv error: reject before any (possibly minutes-long) solve
        print("--self needs at least 3 grids", file=sys.stderr)
        return 2
    precision.resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    fields = _order_fields(args, ns)
    if fields is None:
        print(f"unknown family {args.family}")
        return 2

    if args.self_pairs:
        rows = _self_convergence(ns, fields)
        with open(os.path.join(args.outdir, "order_self.txt"), "w") as fh:
            fh.write("# coarse mid fine norm e1 e2 p\n")
            for r in rows:
                fh.write("%d %d %d %s %r %r %.4f\n" % r)
        print(f"{'coarse':>7s}{'mid':>7s}{'fine':>7s}{'norm':>6s}"
              f"{'e1':>13s}{'e2':>13s}{'p':>8s}")
        for r in rows:
            print(f"{r[0]:7d}{r[1]:7d}{r[2]:7d}{r[3]:>6s}"
                  f"{r[4]:13.4e}{r[5]:13.4e}{r[6]:8.2f}")
        # the L2 pair-error series vs coarse grid size
        l2 = [r for r in rows if r[3] == "2"]
        _order_figure(os.path.join(args.outdir, "order_self.png"),
                      [r[0] for r in l2], [r[4] for r in l2],
                      (2, 5) if args.family == "burgers" else (2, 4))
        return 0

    errs = [f[2] for f in fields]
    if any(e is None for e in errs):
        print("no exact solution for this family/bc; use --self",
              file=sys.stderr)
        return 2
    orders = plotting.observed_orders(ns, errs)
    with open(os.path.join(args.outdir, "order.txt"), "w") as fh:
        for n, e in zip(ns, errs):
            fh.write(f"{n} {e!r}\n")
        fh.write("# observed orders: " +
                 " ".join(f"{p:.2f}" for p in orders) + "\n")
    print("grids:", ns)
    print("errors:", errs)
    print("observed orders:", [round(float(p), 2) for p in orders])
    _order_figure(os.path.join(args.outdir, "order.png"), ns, errs,
                  (2, 4) if args.family == "heat" else (2,))
    return 0


def _plot_family(d):
    """Solver family of a run (or sweep) directory, from its metrics —
    the file names alone are ambiguous (euler sweep aliases
    solution_d_<nx>.txt collide with burgers history names)."""
    from cfd_julia_torch import presets

    for fn, pick in (("metrics.json", lambda m: m),
                     ("sweep_metrics.json", lambda m: m[0])):
        p = os.path.join(d, fn)
        if os.path.exists(p):
            try:
                with open(p) as fh:
                    return presets.get(pick(json.load(fh))["preset"]).family
            except (KeyError, IndexError, ValueError, json.JSONDecodeError):
                pass
    return None


_CONTOUR_TITLES = {
    # field_final.txt column meanings per family (run.py writers)
    "cavity": ("vorticity", "streamfunction"),
    "poisson": ("source f", "u", "u_exact"),
}


def cmd_plot(args):
    """Generate the reference's figures from a run directory (the files
    run.py writes); needs matplotlib."""
    from cfd_julia_torch.utils import plotting

    if not plotting.have_matplotlib():
        print("plot needs matplotlib, which is not installed",
              file=sys.stderr)
        return 2
    d = args.rundir
    fam = _plot_family(d)
    made = []
    if os.path.exists(os.path.join(d, "field_final.csv")):
        plotting.heat_final(os.path.join(d, "field_final.csv"),
                            os.path.join(d, "field_final.png"))
        made.append("field_final.png")
    if fam != "euler":
        # euler writes solution_{d,v,e}[_suffix].txt column dumps that
        # would render as nonsense Burgers overlays
        for fn in os.listdir(d):
            if fn.startswith("solution_") and fn.endswith(".txt") \
                    and fn not in ("solution_d.txt", "solution_v.txt",
                                   "solution_e.txt"):
                plotting.burgers_history(os.path.join(d, fn),
                                         os.path.join(d, fn[:-4] + ".png"))
                made.append(fn[:-4] + ".png")
    if os.path.exists(os.path.join(d, "solution_d.txt")):
        plotting.sod_profiles(d, os.path.join(d, "sod.png"),
                              true_dir=args.true_dir)
        made.append("sod.png")
    if os.path.exists(os.path.join(d, "field_final.txt")):
        p = os.path.join(d, "field_final.txt")
        with open(p) as fh:
            ncols = len(fh.readline().split())
        n_fields = max(1, ncols - 2)
        titles = _CONTOUR_TITLES.get(
            fam, tuple(f"field {k + 1}" for k in range(n_fields)))
        plotting.field_contours(p, os.path.join(d, "contours.png"),
                                n_fields=n_fields, titles=titles)
        made.append("contours.png")
    # vortex snapshot dumps vm1..vmN.txt: contour the LAST snapshot
    # (vm.jl:78-86 writes them; the reference plots the final state)
    vms = sorted((fn for fn in os.listdir(d)
                  if fn.startswith("vm") and fn.endswith(".txt")
                  and fn[2:-4].isdigit()),
                 key=lambda fn: int(fn[2:-4]))
    if vms:
        plotting.field_contours(os.path.join(d, vms[-1]),
                                os.path.join(d, "vorticity.png"),
                                n_fields=1, titles=("vorticity",))
        made.append("vorticity.png")
    hists = {
        fn[:-len("_residual.txt")]: os.path.join(d, fn)
        for fn in os.listdir(d) if fn.endswith("_residual.txt")
    }
    if hists:
        plotting.residual_comparison(
            hists, os.path.join(d, "residuals.png"))
        made.append("residuals.png")
    print("wrote:", ", ".join(made) if made else "(nothing to plot)")
    return 0


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a GPU — a CPU run says --device cpu)")


def main(argv=None):
    # allow_abbrev=False: prefix matching would take "--re 100" as an
    # abbreviation of --resume
    parser = argparse.ArgumentParser(prog="cfd_julia_torch",
                                     allow_abbrev=False)
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", allow_abbrev=False)
    pr = sub.add_parser("run", allow_abbrev=False)
    pr.add_argument("preset")
    pr.add_argument("--outdir", default="out")
    _device_arg(pr)
    pr.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", dest="checkpoint_every",
                    help="save a resumable checkpoint to "
                         "OUTDIR/checkpoint.npz every N steps (cavity and "
                         "vortex families)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from OUTDIR/checkpoint.npz if present")
    pr.add_argument("--sweep", default=None, metavar="FIELD=V1,V2,...",
                    help="run the preset once per value (reference-style "
                         "grid sweep): per-point subdirectories + "
                         "aggregated sweep_metrics.json")
    pv = sub.add_parser("validate", allow_abbrev=False)
    _device_arg(pv)
    pa = sub.add_parser("run-all", allow_abbrev=False)
    pa.add_argument("--outdir", default="out")
    pa.add_argument("--full", action="store_true",
                    help="full reference configs (slow)")
    _device_arg(pa)
    po = sub.add_parser("order", allow_abbrev=False)
    po.add_argument("family", choices=["heat", "burgers", "poisson"])
    po.add_argument("--scheme", default=None)
    po.add_argument("--grids", default="32,64,128,256")
    po.add_argument("--outdir", default="out")
    po.add_argument("--self", dest="self_pairs", action="store_true",
                    help="grid-pair self-convergence: interpolate finer "
                         "solutions onto each coarser grid and form error "
                         "ratios; no exact solution needed "
                         "(06_.../order.jl:53-75)")
    po.add_argument("--bc", default="periodic",
                    choices=["periodic", "dirichlet"],
                    help="burgers only; dirichlet requires --self")
    _device_arg(po)
    pp = sub.add_parser("plot", allow_abbrev=False)
    pp.add_argument("rundir")
    pp.add_argument("--true-dir", default=None)

    args, extra = parser.parse_known_args(argv)
    if extra and args.cmd != "run":
        # only `run` takes free-form config overrides; anywhere else a
        # leftover is a misspelled flag
        print(f"unrecognized arguments: {' '.join(extra)}",
              file=sys.stderr)
        return 2
    if args.cmd == "run":
        return cmd_run(args, extra)
    return {"list": cmd_list, "validate": cmd_validate,
            "run-all": cmd_run_all, "order": cmd_order,
            "plot": cmd_plot}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
