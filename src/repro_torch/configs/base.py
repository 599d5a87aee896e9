"""Model and training configuration, from ``src/repro/configs/base.py``.

``ModelConfig`` has the fields the dense families use, with the JAX
config's names and defaults, so a config compares field by field with its
reference; only the dtypes are torch's.  The other families' fields come
with their slices; shape, mesh and rank-schedule configs with theirs.
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
    loss_chunk: int = 2048  # tokens per chunked-xent block
    remat: str = "block"  # none | block: recompute each block in backward

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``src/repro/configs/base.py::TrainConfig`` that the
    port's train step and loop read, with the JAX defaults.  The refresh
    cadence (``tau``, ``refresh_groups``) and gradient clipping are read
    from the optimizer's ``OptimizerConfig``.  Recovery, spectrum-logging,
    sharded-checkpoint and rank-schedule fields come with their slices
    (ROADMAP queue 1).

    ``train_loop`` restores from ``checkpoint_dir`` whenever it holds
    checkpoints, so a caller that must start fresh passes a directory of
    its own: the default is shared by every run on the machine."""

    total_steps: int = 10000
    seed: int = 0
    microbatch: int = 0  # 0 = no gradient accumulation
    # Gradient-accumulation partial-sum dtype.  f32 by default: bf16 partial
    # sums lose low-order bits across microbatches.  The accumulated
    # gradient is cast back to the param dtype either way.
    accum_dtype: Any = torch.float32
    # checkpoints: a save every ``checkpoint_every`` steps (0: none), the
    # newest ``keep_checkpoints`` kept, written on a background thread
    # after a host snapshot when ``async_checkpoint`` (train/checkpoint.py)
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
