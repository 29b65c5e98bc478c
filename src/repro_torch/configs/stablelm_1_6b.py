"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: dense,
LayerNorm, full MHA (kv=32); port of `repro.configs.stablelm_1_6b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352, use_layernorm=True, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, use_layernorm=True, rope_theta=10000.0,
)
