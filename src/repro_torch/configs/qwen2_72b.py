"""Qwen2-72B [arXiv:2407.10671; hf]: dense, GQA kv=8, QKV bias; port of
`repro.configs.qwen2_72b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, qkv_bias=True, rope_theta=1e6,
)
