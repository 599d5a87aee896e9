"""Three-term roofline of a step, from ``src/repro/roofline/analysis.py``,
on the H100 constants of ``hw.py``:

    compute_term    = operations per card / hw.PEAK_FLOPS_BF16
    memory_term     = bytes per card / hw.HBM_BYTES_PER_S
    collective_term = collective bytes per card / hw.COLLECTIVE_BYTES_PER_S

The reference reads the operations and bytes from a compiled XLA
executable (``cost_analysis``) and the collective bytes from its HLO text.
The port compiles no graph, so ``analyze`` takes them counted: the dry run
(``launch/dryrun.py``) counts them from the shapes, and the collectives'
bytes from the models the train step's collectives are held to
(``models.tp_hot_comm_bytes``, ``core/lowrank.fsdp_hot_comm_bytes``,
``core/buckets.dp_comm_model``).  ``collective_stats`` and
``scan_corrections`` read HLO and correct XLA's single count of a loop
body, so they have no counterpart.

``model_flops`` is the analytic useful work (6 N D to train, 2 N D to
infer, plus the causal-halved attention terms, MoE-active aware), and
``model_bytes`` the least traffic a step must move; the report's
``useful_ratio`` is the first over the counted operations.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline import hw


@dataclasses.dataclass
class RooflineReport:
    """The reference's report, field for field.  ``hlo_flops`` and
    ``hlo_bytes`` keep their names but hold the counted operations and
    bytes per card (the port has no HLO)."""

    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float  # per card
    hlo_bytes: float  # per card
    collective_bytes: float  # per card
    compute_term_s: float
    memory_term_s: float
    collective_term_s: float
    bottleneck: str
    model_flops: float  # global useful operations
    useful_ratio: float  # model_flops / (hlo_flops * n_chips)
    memory_per_device: Dict[str, float]
    collectives: Dict[str, Any]
    extra: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @property
    def step_time_bound_s(self) -> float:
        return max(self.compute_term_s, self.memory_term_s, self.collective_term_s)

    def roofline_fraction(self) -> float:
        """max(useful compute, least traffic) time over the bound step time
        (the traffic floor keeps a decode step, bound by its bytes, from
        scoring ~0)."""
        useful_t = (self.model_flops / self.n_chips) / hw.PEAK_FLOPS_BF16
        min_bytes = self.extra.get("model_bytes", 0.0)
        traffic_t = (min_bytes / self.n_chips) / hw.HBM_BYTES_PER_S
        bound = self.step_time_bound_s
        return max(useful_t, traffic_t) / bound if bound > 0 else 0.0


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    model_flops: float,
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    collectives: Optional[Dict[str, Any]] = None,
    memory_per_device: Optional[Dict[str, float]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> RooflineReport:
    """The report of a step that does ``flops`` operations, moves
    ``bytes_accessed`` bytes and hands ``collective_bytes`` to collectives,
    all per card; ``collectives`` itemizes the last (bytes by axis or
    kind)."""
    compute_t = flops / hw.PEAK_FLOPS_BF16
    memory_t = bytes_accessed / hw.HBM_BYTES_PER_S
    collective_t = collective_bytes / hw.COLLECTIVE_BYTES_PER_S
    terms = {"compute": compute_t, "memory": memory_t, "collective": collective_t}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=float(flops), hlo_bytes=float(bytes_accessed),
        collective_bytes=float(collective_bytes),
        compute_term_s=compute_t, memory_term_s=memory_t, collective_term_s=collective_t,
        bottleneck=max(terms, key=terms.get),
        model_flops=float(model_flops),
        useful_ratio=model_flops / (flops * n_chips) if flops > 0 else 0.0,
        memory_per_device=dict(memory_per_device or {}),
        collectives=dict(collectives or {}),
        extra=dict(extra or {}),
    )


# ---------------------------------------------------------------------------
# analytic useful work and least traffic (the reference's formulas)
# ---------------------------------------------------------------------------


def active_params(cfg: ModelConfig, total_params: int) -> float:
    """Parameters a token meets (MoE: the routed experts it is sent to)."""
    if cfg.family != "moe" or not cfg.n_experts:
        return float(total_params)
    per_expert = 3 * cfg.d_model * cfg.d_ff  # swiglu expert
    routed = cfg.n_layers * cfg.n_experts * per_expert
    active_routed = cfg.n_layers * cfg.moe_top_k * per_expert
    return float(total_params - routed + active_routed)


def model_bytes(cfg: ModelConfig, shape: ShapeConfig, total_params: int) -> float:
    """Least global traffic per step: train reads the params, writes the
    gradients and rewrites the params (f32); prefill reads the params once
    (bf16) and writes the KV cache; decode reads the params and the whole
    KV or SSM cache."""
    b, s = shape.global_batch, shape.seq_len
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "audio" else 0)
    kv_cache = 2.0 * layers * b * s * cfg.kv_dim * 2.0 if cfg.n_heads else 0.0
    if cfg.attn_window:
        kv_cache = 2.0 * layers * b * min(s, cfg.attn_window) * cfg.kv_dim * 2.0
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * cfg.d_model
        kv_cache += (4.0 * cfg.n_layers * b * (d_inner // cfg.ssm_head_dim)
                     * cfg.ssm_head_dim * cfg.ssm_state)
    if shape.kind == "train":
        return 3.0 * total_params * 4.0
    return total_params * 2.0 + kv_cache


def model_flops(cfg: ModelConfig, shape: ShapeConfig, total_params: int) -> float:
    """Useful operations per step (PaLM-style, causal-halved attention)."""
    n_act = active_params(cfg, total_params)
    b, s = shape.global_batch, shape.seq_len
    d_tokens = b * s
    attn_q = cfg.q_dim if cfg.n_heads else 0
    layers = cfg.n_layers + cfg.n_enc_layers
    if shape.kind == "train":
        base = 6.0 * n_act * d_tokens
        attn = 6.0 * layers * b * s * s * attn_q * 0.5 * 2  # qk + pv, fwd + bwd
        return base + attn
    if shape.kind == "prefill":
        base = 2.0 * n_act * d_tokens
        attn = 2.0 * layers * b * s * s * attn_q * 0.5 * 2 / 3.0
        return base + attn
    # decode: one token per sequence against an s-long cache
    base = 2.0 * n_act * b
    attn = 4.0 * layers * b * s * attn_q
    if cfg.attn_window:
        attn = 4.0 * layers * b * min(s, cfg.attn_window) * attn_q
    return base + attn
