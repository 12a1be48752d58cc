"""Multi-device layer of the port on torch.distributed (counterpart of
cfd_julia_tpu/parallel/): mesh.py, halo.py, sharded.py, and launch.py,
which starts the ranks."""
