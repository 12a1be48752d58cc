"""Runnable examples of the port (counterparts of the repository's
examples/ scripts), each `python -m cfd_julia_torch.examples.<name>` with
--device (default cuda; a CPU run says --device cpu):

  cavity_ghia         the cavity to steady state against Ghia et al. (1982)
  vortex_merger       the vortex merger's snapshots and a contour figure
  vortex_diagnostics  E(k) and the enstrophy budget dZ/dt = -2 nu P
  adjoint_cavity      d(loss)/dRe of the cavity through torch.autograd
  multichip_cavity    the cavity sharded over a mesh of ranks (--ranks)

Each module's main(argv) prints its checks and returns them as a dict.
"""
