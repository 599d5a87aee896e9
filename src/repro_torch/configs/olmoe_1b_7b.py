"""olmoe-1b-7b [arXiv:2409.02060; hf]: 64 experts top-8, no shared experts."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    n_experts=64, n_shared_experts=0, moe_top_k=8,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512, n_experts=8, n_shared_experts=0, moe_top_k=2,
    loss_chunk=64, attn_chunk_q=16, attn_chunk_kv=16,
)
