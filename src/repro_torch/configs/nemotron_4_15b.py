"""nemotron-4-15b [arXiv:2402.16819; unverified]: GQA kv=8, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, mlp_kind="squared_relu",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, loss_chunk=64,
    attn_chunk_q=16, attn_chunk_kv=16,
)
