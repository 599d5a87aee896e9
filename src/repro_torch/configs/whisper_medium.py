"""whisper-medium [arXiv:2212.04356; unverified]: enc-dec, conv frontend
STUBBED (the caller supplies precomputed 1500-frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865, enc_frames=1500,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, enc_frames=24, loss_chunk=64,
    attn_chunk_q=16, attn_chunk_kv=16,
)
