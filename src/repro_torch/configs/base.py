"""Model and training configuration, from ``src/repro/configs/base.py``.

``ModelConfig`` has the fields of every family (dense, MoE, SSM,
hybrid, enc-dec and VLM), with the JAX config's names and defaults, so a
config compares field by field with its reference; only the dtypes are
torch's.  ``RankSchedule`` is the reference's rank schedule, field for
field (its evaluation lives in ``core/rank_schedule.py``).  ``MeshConfig``
names the data-parallel mesh (``launch/mesh.py``).  ``ShapeConfig`` and
``SHAPES`` are the reference's four input shapes, which with the archs
make the cells (``registry.cells``, ``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    router_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25  # EP dispatch capacity (local path is dropless)

    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_head_tp: bool = False  # SSD heads split over ``model`` (models/ssm.py)

    # --- hybrid (hymba) ---
    attn_window: int = 0  # 0 = global attention; >0 = sliding window

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500

    # --- VLM (llava) ---
    n_patches: int = 0  # patch-embedding prefix length for train shape

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


# ---------------------------------------------------------------------------
# Input shapes (the assigned shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """Rank as a schedule, from ``src/repro/configs/base.py``: ranks move
    only at refresh boundaries, where the train loop re-buckets.

    Kinds: ``constant`` (stays at ``start``), ``step`` (halves from
    ``start`` toward ``floor`` in equal segments of the decay window),
    ``linear`` and ``cosine`` (interpolate start -> floor), ``adaptive``
    (per group: ``margin`` times the measured effective rank of the
    refresh step's update, clamped to [floor, start]).  ``decay_fraction``
    is the share of the run the decay spans; ``total_steps=0`` takes the
    horizon at evaluation.  Ranks snap to multiples of ``granularity``, and
    a change smaller than ``hysteresis`` (0: the granularity) is ignored.

    Spec strings (``parse`` / ``spec``): ``kind:start[:floor][@fraction]``,
    e.g. ``"cosine:128:32@0.5"``."""

    kind: str = "constant"
    start: int = 128
    floor: int = 0  # 0 -> start (no decay)
    decay_fraction: float = 1.0
    total_steps: int = 0
    granularity: int = 8
    hysteresis: int = 0
    margin: float = 1.25

    KINDS = ("constant", "step", "linear", "cosine", "adaptive")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown rank-schedule kind {self.kind!r}; have {self.KINDS}")
        if self.start < 1:
            raise ValueError(f"rank schedule start must be >= 1: {self.start}")
        if self.floor < 0 or self.floor > self.start:
            raise ValueError(f"rank schedule floor must be in [0, start]: "
                             f"floor={self.floor} start={self.start}")
        if not (0.0 < self.decay_fraction <= 1.0):
            raise ValueError(f"decay_fraction must be in (0, 1]: {self.decay_fraction}")
        if self.granularity < 1:
            raise ValueError(f"granularity must be >= 1: {self.granularity}")

    @property
    def effective_floor(self) -> int:
        return self.floor if self.floor > 0 else self.start

    @property
    def effective_hysteresis(self) -> int:
        return self.hysteresis if self.hysteresis > 0 else self.granularity

    @classmethod
    def parse(cls, spec: str, **overrides: Any) -> "RankSchedule":
        """``"cosine:128:32@0.5"`` -> RankSchedule; floor and fraction are
        optional (``"constant:64"``, ``"linear:128:32"``)."""
        s = spec.strip()
        if not s:
            raise ValueError("empty rank-schedule spec")
        frac = 1.0
        if "@" in s:
            s, frac_s = s.rsplit("@", 1)
            try:
                frac = float(frac_s)
            except ValueError:
                raise ValueError(
                    f"bad decay fraction {frac_s!r} in rank schedule {spec!r}") from None
        parts = s.split(":")
        try:
            start = int(parts[1]) if len(parts) > 1 else 128
            floor = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            raise ValueError(f"bad rank-schedule spec {spec!r}") from None
        if len(parts) > 3:
            raise ValueError(f"bad rank-schedule spec {spec!r}")
        kw = dict(kind=parts[0], start=start, floor=floor, decay_fraction=frac)
        kw.update(overrides)
        return cls(**kw)

    def spec(self) -> str:
        """The inverse of ``parse`` (the positional fields)."""
        return f"{self.kind}:{self.start}:{self.floor}@{self.decay_fraction:g}"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The mesh's shape and axis names, as ``src/repro/configs/base.py``'s:
    (pod, data, model) when ``multi_pod``, else (data, model).  The port
    runs the data-parallel axes; a ``model`` extent above 1 raises in
    ``launch/mesh.make_mesh``."""

    multi_pod: bool = False
    shape: Optional[Tuple[int, ...]] = None

    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    def default_shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``src/repro/configs/base.py::TrainConfig`` that the
    port's train step and loop read, with the JAX defaults.  The refresh
    cadence (``tau``, ``refresh_groups``) and gradient clipping are read
    from the optimizer's ``OptimizerConfig``, and so is the rank schedule
    the loop evaluates (``OptimizerConfig.rank_schedule``).

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
    # the refresh-cadence spectrum probe (train/monitor.SpectrumLogger):
    # one SVD of a probe leaf's update per refresh, logged to the history
    log_spectrum: bool = False
    # checkpoints: a save every ``checkpoint_every`` steps (0: none), the
    # newest ``keep_checkpoints`` kept, written on a background thread
    # after a host snapshot when ``async_checkpoint`` (train/checkpoint.py)
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    # the shard-parallel format for a ZeRO run (state_sharding="zero",
    # state_shards > 1): each writer saves only its rows of the bucket
    # stacks, with no canonical gather (train/checkpoint.py); False keeps
    # the canonical per-leaf format
    sharded_checkpoint: bool = True
