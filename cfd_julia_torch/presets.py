"""Named reference configurations (counterpart of cfd_julia_tpu/presets.py).

All 29 of the JAX package's presets: the 1D heat and Burgers families, the
1D Euler Sod shock tube, the direct (FFT / DST), iterative and multigrid 2D
Poisson solvers, the lid-driven cavity, and the periodic vortex merger /
Taylor-Green solvers.  Run with
`python -m cfd_julia_torch run <preset>`; any config field can be
overridden on the command line (e.g. --nx 1024).
"""
from __future__ import annotations

import dataclasses

from cfd_julia_torch.models import (burgers1d, cavity, euler1d, heat1d,
                                    poisson2d, vortex)
from cfd_julia_torch.poisson import multigrid


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    family: str          # heat | burgers | euler | poisson | cavity | vortex
    cfg: object
    reference: str       # reference script this mirrors
    description: str = ""


PRESETS = {
    p.name: p
    for p in [
        # --- 1D heat (ch. 01-04) ---------------------------------------------
        Preset("heat_ftcs", "heat", heat1d.HeatConfig(scheme="ftcs"),
               "01_Heat_Equation_FTCS/ftcs.jl", "explicit FTCS, nx=80"),
        Preset("heat_rk3", "heat", heat1d.HeatConfig(scheme="rk3"),
               "02_Heat_Equation_RK3/rk3.jl", "SSP-RK3"),
        Preset("heat_cn", "heat", heat1d.HeatConfig(scheme="cn"),
               "03_Heat_Equation_CN/cn.jl", "Crank-Nicolson"),
        Preset("heat_icp", "heat", heat1d.HeatConfig(scheme="icp"),
               "04_Heat_Equation_ICP/icp.jl",
               "implicit compact Pade (4th order)"),
        # --- 1D Burgers (ch. 05-08) ------------------------------------------
        Preset("burgers_weno_dirichlet", "burgers",
               burgers1d.BurgersConfig(nx=400, solver="weno", bc="dirichlet"),
               "05_Inviscid_Burgers_WENO/weno_dirichlet.jl"),
        Preset("burgers_weno_periodic", "burgers",
               burgers1d.BurgersConfig(nx=400, solver="weno", bc="periodic"),
               "05_Inviscid_Burgers_WENO/weno_periodic.jl"),
        Preset("burgers_central", "burgers",
               burgers1d.BurgersConfig(nx=400, solver="central",
                                       bc="dirichlet"),
               "05_Inviscid_Burgers_WENO/weno_trial.jl",
               "central-difference baseline"),
        Preset("burgers_crweno_dirichlet", "burgers",
               burgers1d.BurgersConfig(nx=1600, solver="crweno",
                                       bc="dirichlet"),
               "06_Inviscid_Burgers_CRWENO/crweno_dirichlet.jl"),
        Preset("burgers_crweno_periodic", "burgers",
               burgers1d.BurgersConfig(nx=1600, solver="crweno",
                                       bc="periodic"),
               "06_Inviscid_Burgers_CRWENO/crweno_periodic.jl"),
        Preset("burgers_flux_splitting", "burgers",
               burgers1d.BurgersConfig(nx=150, solver="flux_split"),
               "07_Inviscid_Burgers_Flux_Splitting/"
               "burgers_flux_splitting.jl"),
        Preset("burgers_riemann", "burgers",
               burgers1d.BurgersConfig(nx=200, solver="rusanov"),
               "08_Inviscid_Burgers_Rieman/burgers_riemann.jl"),
        # --- 1D Euler Sod (ch. 09-11) ----------------------------------------
        Preset("euler_roe", "euler", euler1d.EulerConfig(nx=256, solver="roe"),
               "09_Euler_1D_Roe/euler_roe.jl"),
        Preset("euler_hllc", "euler",
               euler1d.EulerConfig(nx=8192, solver="hllc", dt=5e-5),
               "10_Euler_1D_HLLC/euler_hllc.jl", "high-res 'True' run"),
        Preset("euler_rusanov", "euler",
               euler1d.EulerConfig(nx=8192, solver="rusanov", dt=5e-5),
               "11_Euler_1D_Rusanov/euler_rusanov.jl"),
        # --- 2D Poisson (ch. 12-17) ------------------------------------------
        Preset("poisson_fft", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="fft",
                                       problem="sine32"),
               "12_Poisson_Solver_FFT/fft_p.jl", "FDM eigenvalues"),
        Preset("poisson_fft_spectral", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="fft_spectral",
                                       problem="sine32"),
               "13_Poisson_Solver_FFT_Spectral/fft_s.jl"),
        Preset("poisson_fst", "poisson",
               poisson2d.PoissonConfig(nx=128, ny=128, solver="fst",
                                       problem="sine32"),
               "14_Poisson_Solver_FST/fft_d.jl", "DST-I direct solve"),
        Preset("poisson_jacobi", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="jacobi",
                                       problem="poly", tol=1e-9,
                                       max_iter=2_000_000, freq=10_000),
               "15_Poisson_Solver_Gauss_Seidel/gauss_seidel.jl",
               "the reference's 'gauss_seidel' is point Jacobi"),
        Preset("poisson_gs_redblack", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="redblack",
                                       problem="poly", tol=1e-9,
                                       max_iter=2_000_000, freq=10_000),
               "15_... (data-parallel true Gauss-Seidel variant)",
               "red-black GS: data-parallel true GS"),
        Preset("poisson_cg", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="cg",
                                       problem="poly", tol=1e-9,
                                       # 20 * 100_000, the reference
                                       # main()'s cap (conjugate_gradient.jl)
                                       max_iter=2_000_000, freq=100),
               "16_Poisson_Solver_Conjugate_Gradient/conjugate_gradient.jl"),
        Preset("poisson_mg2", "poisson",
               poisson2d.PoissonConfig(nx=256, ny=256, solver="multigrid",
                                       problem="poly",
                                       mg=multigrid.MGConfig(
                                           n_levels=2, tol=1e-9,
                                           max_cycles=1000)),
               "17_Poisson_Solver_Multigrid/mg.jl", "2-level V-cycle"),
        Preset("poisson_mgcg", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="mgcg",
                                       problem="poly", tol=1e-9),
               "16_.../conjugate_gradient.jl + 17_.../mg_N.jl",
               "V-cycle-preconditioned flexible CG (beyond the reference)"),
        Preset("poisson_mgN", "poisson",
               poisson2d.PoissonConfig(nx=512, ny=512, solver="multigrid",
                                       problem="poly",
                                       mg=multigrid.MGConfig(
                                           n_levels=9, tol=1e-9,
                                           max_cycles=100)),
               "17_Poisson_Solver_Multigrid/mg_N.jl", "9-level V-cycle"),
        # --- 2D Navier-Stokes (ch. 18-22) ------------------------------------
        Preset("cavity", "cavity", cavity.CavityConfig(),
               "18_NS2D_Lid_Driven_Cavity/lid_driven_cavity.jl",
               "Re=100, 64^2, t=10"),
        Preset("vortex_merger_fdm", "vortex",
               vortex.VortexConfig(solver="fdm"),
               "19_NS2D_Vortex_Merger/vm.jl", "128^2, Re=1000, t=20"),
        Preset("tgv", "vortex",
               vortex.VortexConfig(nx=64, ny=64, solver="fdm", dt=0.01,
                                   t_final=1.0, re=10.0, ic="tgv", ns=1),
               "19_NS2D_Vortex_Merger/tgv.jl", "Taylor-Green validation"),
        Preset("vortex_merger_hybrid", "vortex",
               vortex.VortexConfig(solver="hybrid"),
               "20_NS2D_Hybrid_Solver/hybrid.jl", "semi-implicit RK3/CN"),
        Preset("vortex_merger_ps32", "vortex",
               vortex.VortexConfig(solver="ps32"),
               "21_NS2D_PseudoSpectral_32_Rule/pseudospectral_32_rule.jl"),
        Preset("vortex_merger_ps23", "vortex",
               vortex.VortexConfig(solver="ps23"),
               "22_NS2D_PseudoSpectral_23_Rule/pseudospectral_23_rule.jl"),
    ]
}


def get(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        )
    return PRESETS[name]


def with_overrides(preset: Preset, **overrides) -> Preset:
    """Replace config fields (CLI --key value overrides)."""
    if not overrides:
        return preset
    cfg = dataclasses.replace(preset.cfg, **overrides)
    return dataclasses.replace(preset, cfg=cfg)
