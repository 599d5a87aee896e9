"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Per family, as in ``src/repro/kernels``: ``kernel.py`` wraps the kernel
(Triton, or CUDA C++ from ``csrc/`` built by ``build.py``), ``ref.py`` is
the plain version, ``ops.py`` dispatches by the tensors' device.
"""
