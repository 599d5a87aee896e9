"""repro_torch.core -- the paper's contribution: SARA low-rank optimization,
from ``src/repro/core``."""
from repro_torch.core.api import OptimizerConfig, make_optimizer, parse_name
from repro_torch.core.lowrank import (
    LowRankOptimizer,
    LowRankOptState,
    make_lowrank_optimizer,
    optimizer_memory_report,
    state_memory_bytes,
)

__all__ = [
    "OptimizerConfig",
    "make_optimizer",
    "parse_name",
    "LowRankOptimizer",
    "LowRankOptState",
    "make_lowrank_optimizer",
    "optimizer_memory_report",
    "state_memory_bytes",
]
