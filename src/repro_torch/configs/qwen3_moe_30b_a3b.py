"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf]: MoE 128 experts top-8, GQA
kv=4, qk-norm; port of `repro.configs.qwen3_moe_30b_a3b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab=512, qk_norm=True, n_experts=8, top_k=2, capacity_factor=4.0,
)
