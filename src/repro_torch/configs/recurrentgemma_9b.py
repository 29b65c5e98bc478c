"""RecurrentGemma-9B / Griffin [arXiv:2402.19427; unverified]: RG-LRU
recurrent blocks + local attention (window 2048), pattern rec:rec:attn,
MQA (kv=1); port of `repro.configs.recurrentgemma_9b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, d_rnn=4096, sliding_window=2048,
    block_pattern=("rec", "rec", "attn"), rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="rglru",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, d_rnn=64, sliding_window=8,
    block_pattern=("rec", "rec", "attn"),
)
