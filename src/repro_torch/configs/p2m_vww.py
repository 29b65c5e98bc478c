"""The paper's own benchmark: MobileNetV2-VWW with the P²M first layer
(Table 1 hyperparameters: k=5, s=5, p=0, c_o=8, N_b=8); port of
`repro.configs.p2m_vww`."""
from repro_torch.core.p2m_conv import P2MConvConfig
from repro_torch.models.mobilenetv2 import MNV2Config

P2M_LAYER = P2MConvConfig(kernel=5, stride=5, in_channels=3, out_channels=8,
                          n_bits=8)

CONFIG = MNV2Config(variant="p2m", image_size=560, p2m=P2M_LAYER)
BASELINE = MNV2Config(variant="baseline", image_size=560)

# reduced configs for CPU runs and tests
SMOKE = MNV2Config(variant="p2m", image_size=80, width=0.25, head_channels=64,
                   p2m=P2M_LAYER)
SMOKE_BASELINE = MNV2Config(variant="baseline", image_size=80, width=0.25,
                            head_channels=64)

# Batched vision serving defaults (serving/vision.py).  Microbatch 8;
# queue depth 64 rides out ~8 launches of burst before the oldest-frame
# eviction policy sheds.
SERVE_MAX_BATCH = 8
SERVE_MAX_QUEUE = 64
SERVE_QUANT_BITS = 8  # PTQ width for the deploy-folded stem (Table 1 N_b)
