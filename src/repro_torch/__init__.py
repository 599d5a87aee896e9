"""PyTorch / CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package ``src/repro`` is the reference; this package mirrors its
module names (``configs``, ``kernels``, ``models``, ``serve``, ``launch``)
so each module's counterpart is found by path.  It imports ``torch`` and
never ``jax`` or ``repro``.  Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
