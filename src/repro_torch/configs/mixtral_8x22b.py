"""Mixtral-8x22B [arXiv:2401.04088; hf]: MoE 8 experts top-2, GQA kv=8,
sliding-window attention; port of `repro.configs.mixtral_8x22b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, rope_theta=1e6,
    n_experts=8, top_k=2, sliding_window=4096,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=512, n_experts=4, top_k=2, sliding_window=16, capacity_factor=4.0,
)
