"""Paged decode attention dispatch
(``models/attention.paged_decode_attention`` routes here): the CUDA kernel
for CUDA tensors, the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention_decode.kernel import (
    paged_decode_attention_kernel,
)
from repro_torch.kernels.flash_attention_decode.ref import (
    paged_decode_attention_ref,
)


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    pages_k: torch.Tensor,  # (P, ps, KVH, D)
    pages_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, MP) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, pages_k, pages_v, page_table, seq_lens, window=window
        )
    return paged_decode_attention_kernel(
        q, pages_k, pages_v, page_table, seq_lens, window=window
    )
