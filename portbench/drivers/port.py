"""The program's own configuration objects, made from a configuration
file; the only place the drivers translate sizes into the port's types."""
from __future__ import annotations

import torch


def mnv2_config(cfg: dict):
    from repro_torch.core.p2m_conv import P2MConvConfig
    from repro_torch.models import mobilenetv2

    blocks = [tuple(b) for b in cfg["blocks"]]
    if blocks != [tuple(b) for b in mobilenetv2.MNV2_BLOCKS]:
        raise ValueError("the program's MobileNetV2 block schedule differs "
                         "from the configuration's")
    return mobilenetv2.MNV2Config(
        variant="p2m", image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], width=cfg["width"],
        head_channels=cfg["head_channels"],
        last_block_div=cfg["last_block_div"],
        first_channels=cfg["first_channels"],
        p2m=P2MConvConfig(**cfg["p2m"]))


def rwkv_config(cfg: dict, **extra):
    from repro_torch.models.config import ModelConfig

    if cfg["dtype"] != "float32":
        raise ValueError("the RWKV driver runs float32 configurations")
    return ModelConfig(
        name="rwkv6", family="rwkv", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_heads"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        rwkv_head_dim=cfg["head_dim"], rwkv_lora_dim=cfg["lora_dim"],
        norm_eps=cfg["norm_eps"], dtype=torch.float32, **extra)


def p2m_launches() -> dict:
    """The P²M kernels' launch counters: B1, B2, B3, B4."""
    from repro_torch.kernels.p2m_conv import backward, conv

    return {"B1": conv.p2m_conv_fused.launches,
            "B2": conv.p2m_conv_fused.launches_pipelined,
            "B3": backward.p2m_bwd_dx.launches,
            "B4": backward.p2m_bwd_dw.launches}


def wkv_launches() -> int:
    from repro_torch.kernels.rwkv_wkv import kernel

    return kernel.wkv_fused.launches


def tuner_decisions() -> dict:
    from repro_torch.kernels.p2m_conv import tune

    return tune.cache_info()


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
