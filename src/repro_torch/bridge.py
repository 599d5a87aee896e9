"""Carry weights between the JAX package and the port, through numpy.

Both packages keep one parameter layout: nested dicts with the same leaf
names and shapes, including the scan-stacked ``(L, ...)`` block leaves.
So a JAX tree turned into numpy (``jax.tree.map(np.asarray, params)``),
or the ``.npy`` leaves of a JAX checkpoint, map name for name onto the
port's params, and back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]


def params_from_numpy(tree: Tree, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``,
    dtypes kept (bit-exact)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Tree:
    """Nested dict of tensors -> the same dict of numpy arrays, bit-exact
    except that bf16 leaves widen (exactly) to f32: numpy has no bf16."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return conv(params)
