"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE, 2 shared + 64
routed top-6 experts, MHA (kv = heads = 16)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    n_experts=64, n_shared_experts=2, moe_top_k=6,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512, n_experts=8, n_shared_experts=2, moe_top_k=2,
    loss_chunk=64, attn_chunk_q=16, attn_chunk_kv=16,
)
