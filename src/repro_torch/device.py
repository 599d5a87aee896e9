"""Device policy of the port's entry points.

Every entry point (``build_model``, ``init_params``, the engines,
``launch/serve.py``) takes ``device`` and defaults to ``"cuda"``.  With no
card and no explicit ``device="cpu"`` it raises: the port never falls back
to the CPU on its own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless asked otherwise, and "
                "torch.cuda.is_available() is False: pass device='cpu' to run "
                "on the CPU"
            )
        # f32 products in full f32: the JAX decode computes its logits in
        # f32 (transformer.py:339-341, paged_decode.py:129-132), and TF32
        # would keep only ~3 decimal digits of them.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        # meta: shapes and dtypes without storage (launch/dryrun.py)
        raise ValueError(f"unsupported device {device!r}: use 'cuda', 'cpu' or 'meta'")
    return dev
