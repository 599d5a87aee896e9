"""Model configuration, from ``src/repro/configs/base.py::ModelConfig``.

The fields the dense families use, with the JAX config's names and
defaults, so a config compares field by field with its reference; only the
dtypes are torch's.  The other families' fields come with their slices;
training, shape, mesh and rank-schedule configs with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    mlp_kind: str = "swiglu"  # swiglu | squared_relu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_window: int = 0  # 0 = global attention; >0 = sliding window

    # --- numerics / impl ---
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"  # auto | exact | chunked | pallas
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 2048  # chunked cross-entropy, for the training slice

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim
