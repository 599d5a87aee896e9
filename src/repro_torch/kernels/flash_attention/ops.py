"""Flash-attention dispatch (``models/attention.py`` routes prefill here).

CUDA tensors go to the hand-written kernel, through its autograd wrapper
where a gradient is wanted (training), CPU tensors to the plain version.
The position arguments keep the models' signature; like the TPU
kernel (``src/repro/kernels/flash_attention/ops.py:5-7``), both paths take
positions to be ``arange``.  So a caller passes either contiguous
self-attention (Sq == Sk, causal or windowed or neither), or attention
with no mask at all (``causal=False``, ``window=0``), where positions do
not enter and Sq and Sk may differ: whisper's cross-attention, Sq tokens
against Sk encoder frames (``models/attention.py`` holds that contract).
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return kernel_lib.flash_attention_autograd(q, k, v, causal=causal, window=window)
    return kernel_lib.flash_attention_fwd(q, k, v, causal=causal, window=window)
