"""qwen2-1.5b [arXiv:2407.10671; hf]: GQA kv=2, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, loss_chunk=64,
    attn_chunk_q=16, attn_chunk_kv=16,
)
