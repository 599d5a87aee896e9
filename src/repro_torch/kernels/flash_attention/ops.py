"""Flash-attention dispatch (``models/attention.py`` routes prefill here).

CUDA tensors go to the hand-written kernel, CPU tensors to the plain
version.  The position arguments keep the models' signature; like the TPU
kernel (``src/repro/kernels/flash_attention/ops.py:5-7``), both paths take
positions to be ``arange``: contiguous self-attention, the only call site.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as kernel_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    del q_positions, kv_positions  # contiguous by contract (see above)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return kernel_lib.flash_attention_fwd(q, k, v, causal=causal, window=window)
