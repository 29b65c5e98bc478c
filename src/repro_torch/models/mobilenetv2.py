"""MobileNetV2 for VWW (paper §5.1), baseline and P²M variants; port of
`repro.models.mobilenetv2`.

The P²M variant replaces the first conv with the in-pixel P²M layer
(k=5, s=5, c_o=8, 8-bit ADC output — Table 1): its train form (conv, BN,
saturating ReLU) or, given a deploy tree, its folded deploy form; the
block schedule is unchanged.  ``train=True`` normalizes every BN by its
batch statistics (mean and population variance over N, H, W) and returns
the new running statistics, ``0.9·old + 0.1·batch``.  Public functions keep the reference's
layout (NHWC activations, parameter trees with its key names); inside,
the backbone runs NCHW tensors in the channels-last memory format, so
the layout changes at the stem and the head are views, not copies.

Parameter trees carry conv weights as OIHW (depthwise ``(C, 1, 3, 3)``)
and the P²M ``theta`` and ``fc`` in the reference's own layout;
`repro_torch.compat` converts a reference tree.  Backbone convs are
PyTorch's own (`F.conv2d`), as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.adc import clip
from repro_torch.core.p2m_conv import (
    P2MConvConfig,
    apply_p2m_conv_deploy,
    apply_p2m_conv_train,
    init_p2m_conv,
    init_p2m_state,
)
from repro_torch.core.pixel_model import PixelModel

# (expansion t, out channels c, repeats n, first-block stride s)
MNV2_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


@dataclasses.dataclass(frozen=True)
class MNV2Config:
    variant: str = "baseline"  # "baseline" | "p2m"
    image_size: int = 560
    num_classes: int = 2
    width: float = 1.0
    head_channels: int = 1280
    last_block_div: int = 3  # paper: reduce last block channels 3×
    first_channels: int = 32
    p2m: P2MConvConfig = dataclasses.field(default_factory=P2MConvConfig)

    def block_schedule(self):
        blocks = []
        for idx, (t, c, n, s) in enumerate(MNV2_BLOCKS):
            c = int(round(c * self.width))
            if idx == len(MNV2_BLOCKS) - 1 and self.last_block_div > 1:
                c = max(8, c // self.last_block_div)
            blocks.append((t, c, n, s))
        return blocks


def smoke_config() -> MNV2Config:
    """Tiny reduced config for CPU smoke tests."""
    return MNV2Config(image_size=40, width=0.25, head_channels=64)


def head_out_channels(cfg: MNV2Config) -> int:
    """Channel width of the pre-pool head conv (never narrower than the
    configured head: the width multiplier only widens it past 1.0)."""
    return int(round(cfg.head_channels * max(1.0, cfg.width)))


# ------------------------------------------------------------------ layers


def _conv_init(gen, k, cin, cout, groups=1):
    fan_in = k * k * cin // groups
    return torch.randn((cout, cin // groups, k, k), generator=gen) * (
        2.0 / fan_in) ** 0.5


def _bn_init(c, device):
    return {"gamma": torch.ones(c, device=device),
            "beta": torch.zeros(c, device=device)}


def _bn_state(c, device):
    return {"mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding: for a 3×3 stride-2 conv on an even size it is
    (0, 1), not PyTorch's symmetric (1, 1)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1, groups=1):
    """NCHW conv with SAME padding."""
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride, groups=groups)


def _bn(x, p, s, train: bool, momentum=0.9, eps=1e-5):
    """BN of an NCHW tensor, in the reference's order of ops: on the
    batch's statistics (population variance) with ``train``, else on the
    running ones.  Returns (y, new state)."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        new_s = {
            "mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * s["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var, new_s = s["mean"], s["var"], s

    def c(v):
        return v.reshape(1, -1, 1, 1)
    y = (x - c(mean)) / torch.sqrt(c(var) + eps) * c(p["gamma"]) + c(
        p["beta"])
    return y, new_s


def _relu6(x):
    return clip(x, 0.0, 6.0)


# ------------------------------------------------------------------ init


def init_mnv2(generator: torch.Generator, cfg: MNV2Config, *,
              device) -> tuple[dict, dict]:
    """Returns (params, state), drawn from ``generator`` (a CPU generator:
    the same seed gives the same weights on any device)."""
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}

    def conv(k, cin, cout, groups=1):
        return _conv_init(generator, k, cin, cout, groups).to(device)

    if cfg.variant == "p2m":
        params["stem"] = init_p2m_conv(generator, cfg.p2m, device=device)
        state["stem"] = init_p2m_state(cfg.p2m, device=device)
        cin = cfg.p2m.out_channels
    else:
        c0 = int(round(cfg.first_channels * cfg.width))
        params["stem"] = {"w": conv(3, 3, c0), "bn": _bn_init(c0, device)}
        state["stem"] = {"bn": _bn_state(c0, device)}
        cin = c0

    bidx = 0
    for t, c, n, s in cfg.block_schedule():
        for _ in range(n):
            hidden = cin * t
            blk: dict[str, Any] = {}
            bst: dict[str, Any] = {}
            if t != 1:
                blk["expand"] = {"w": conv(1, cin, hidden),
                                 "bn": _bn_init(hidden, device)}
                bst["expand"] = {"bn": _bn_state(hidden, device)}
            blk["dw"] = {"w": conv(3, hidden, hidden, groups=hidden),
                         "bn": _bn_init(hidden, device)}
            bst["dw"] = {"bn": _bn_state(hidden, device)}
            blk["project"] = {"w": conv(1, hidden, c),
                              "bn": _bn_init(c, device)}
            bst["project"] = {"bn": _bn_state(c, device)}
            params[f"block{bidx}"] = blk
            state[f"block{bidx}"] = bst
            bidx += 1
            cin = c

    ch = head_out_channels(cfg)
    params["head"] = {"w": conv(1, cin, ch), "bn": _bn_init(ch, device)}
    state["head"] = {"bn": _bn_state(ch, device)}
    params["fc"] = {
        "w": (torch.randn((ch, cfg.num_classes), generator=generator)
              * 0.01).to(device),
        "b": torch.zeros(cfg.num_classes, device=device),
    }
    return params, state


# ------------------------------------------------------------------ apply


def apply_mnv2_stem(
    params: dict,
    state: dict,
    images: torch.Tensor,
    cfg: MNV2Config,
    pixel_model: PixelModel | None = None,
    *,
    train: bool = False,
    p2m_deploy: dict | None = None,
    p2m_impl: str | None = None,
) -> tuple[torch.Tensor, dict]:
    """First layer only: (B, H, W, 3) → (B, Ho, Wo, C) stem activations,
    plus the new stem state.  The P²M variant runs its deploy form when
    given ``p2m_deploy``, else its train form; ``p2m_impl`` selects its
    conv (`core.p2m_conv._resolve_impl`)."""
    if cfg.variant == "p2m":
        if p2m_deploy is not None:
            x = apply_p2m_conv_deploy(p2m_deploy, images, cfg.p2m,
                                      pixel_model, impl=p2m_impl)
            return x, {"stem": state["stem"]}
        x, st = apply_p2m_conv_train(params["stem"], state["stem"], images,
                                     cfg.p2m, pixel_model, train=train,
                                     impl=p2m_impl)
        return x, {"stem": st}
    x = _conv(images.permute(0, 3, 1, 2), params["stem"]["w"], stride=2)
    x, bn_st = _bn(x, params["stem"]["bn"], state["stem"]["bn"], train)
    return _relu6(x).permute(0, 2, 3, 1), {"stem": {"bn": bn_st}}


def apply_mnv2_backbone(
    params: dict,
    state: dict,
    x: torch.Tensor,
    cfg: MNV2Config,
    *,
    train: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Inverted-residual stack + head conv on NHWC stem activations:
    (B, Ho, Wo, C_stem) → (B, h, w, head_channels), plus the new block and
    head state."""
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    new_state: dict[str, Any] = {}
    bidx = 0
    cin = x.shape[1]
    for t, c, n, s in cfg.block_schedule():
        for i in range(n):
            stride = s if i == 0 else 1
            blk = params[f"block{bidx}"]
            bst = state[f"block{bidx}"]
            nst: dict[str, Any] = {}
            y = x
            if t != 1:
                y, st_ = _bn(_conv(y, blk["expand"]["w"]), blk["expand"]["bn"],
                             bst["expand"]["bn"], train)
                nst["expand"] = {"bn": st_}
                y = _relu6(y)
            y = _conv(y, blk["dw"]["w"], stride=stride, groups=y.shape[1])
            y, st_ = _bn(y, blk["dw"]["bn"], bst["dw"]["bn"], train)
            nst["dw"] = {"bn": st_}
            y = _relu6(y)
            y, st_ = _bn(_conv(y, blk["project"]["w"]), blk["project"]["bn"],
                         bst["project"]["bn"], train)
            nst["project"] = {"bn": st_}
            if stride == 1 and cin == c:
                y = y + x
            x = y
            new_state[f"block{bidx}"] = nst
            bidx += 1
            cin = c

    x, st_ = _bn(_conv(x, params["head"]["w"]), params["head"]["bn"],
                 state["head"]["bn"], train)
    new_state["head"] = {"bn": st_}
    x = _relu6(x)
    return x.permute(0, 2, 3, 1), new_state


def apply_mnv2(
    params: dict,
    state: dict,
    images: torch.Tensor,
    cfg: MNV2Config,
    pixel_model: PixelModel | None = None,
    *,
    train: bool = False,
    p2m_deploy: dict | None = None,
    p2m_impl: str | None = None,
) -> tuple[torch.Tensor, dict]:
    """(B, H, W, 3) → (B, num_classes) logits, plus the new state (same
    structure as ``state``)."""
    x, stem_state = apply_mnv2_stem(params, state, images, cfg, pixel_model,
                                    train=train, p2m_deploy=p2m_deploy,
                                    p2m_impl=p2m_impl)
    x, new_state = apply_mnv2_backbone(params, state, x, cfg, train=train)
    x = x.mean(dim=(1, 2))
    logits = x @ params["fc"]["w"] + params["fc"]["b"]
    return logits, {**stem_state, **new_state}
