"""llava-next-34b [hf:llava-hf; unverified]: 34B LM backbone with anyres patch
prefix (vision tower stubbed to precomputed patch embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000, n_patches=576,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_patches=8,
    loss_chunk=64, attn_chunk_q=16, attn_chunk_kv=16,
)
