"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified]:
cross-attention image layers every 5th layer; the vision frontend is a
stub of precomputed patch embeddings, or the P²M frontend
(`core/frontend.py`); port of `repro.configs.llama_3_2_vision_11b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
    cross_attn_period=5, n_image_tokens=1600,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, cross_attn_period=2, n_image_tokens=8,
)
