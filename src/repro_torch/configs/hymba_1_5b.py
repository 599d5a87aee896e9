"""hymba-1.5b [arXiv:2411.13676; hf]: parallel attention+mamba heads,
sliding-window attention (window 1024) + O(1) SSM state."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, attn_window=1024,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
    attn_window=16, loss_chunk=64, attn_chunk_q=16, attn_chunk_kv=16,
)
