"""llama3-8b [arXiv:2407.21783; unverified]: GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, loss_chunk=64,
    attn_chunk_q=16, attn_chunk_kv=16,
)
