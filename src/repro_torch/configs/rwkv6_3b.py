"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf]: attention-free, data-dependent
decay, O(1) decode state; port of `repro.configs.rwkv6_3b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, rwkv_head_dim=64, rwkv_lora_dim=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="rwkv",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, rwkv_head_dim=16, rwkv_lora_dim=8,
)
