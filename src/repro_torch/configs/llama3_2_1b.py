"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified]: dense, GQA kv=8,
tied embeddings; port of `repro.configs.llama3_2_1b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, tie_embeddings=True, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, tie_embeddings=True, rope_theta=500000.0,
)
