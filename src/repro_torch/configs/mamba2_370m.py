"""mamba2-370m [arXiv:2405.21060; unverified]: pure SSD (state-space duality),
attention-free => O(1) decode state."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, mlp_kind="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=8, ssm_head_dim=16,
    ssm_chunk=8, loss_chunk=64,
)
