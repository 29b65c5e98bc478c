"""Whisper-tiny [arXiv:2212.04356; unverified]: encoder-decoder; the conv
frame frontend is a stub of precomputed frame embeddings; port of
`repro.configs.whisper_tiny`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, n_encoder_layers=4,
    max_source_positions=1500, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, n_encoder_layers=2,
    max_source_positions=16, tie_embeddings=True,
)
