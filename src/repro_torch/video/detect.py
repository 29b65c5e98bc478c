"""Anchor-free detection head on the P²M-MobileNetV2 backbone; port of
`repro.video.detect`.

CenterNet-lite after P2M-DeTrack (arXiv:2205.14285): the deploy-folded
P²M stem + MobileNetV2 backbone (`models/mobilenetv2.py` —
``apply_mnv2_stem`` / ``apply_mnv2_backbone``) feeds three small
convolutional heads on the pre-pool feature map:

* **heatmap** (B, h, w, 1): sigmoid objectness, peaks at object centers;
* **size** (B, h, w, 2): sigmoid-normalized box width/height;
* **offset** (B, h, w, 2): sub-cell center offset in [0, 1).

Public functions keep the reference's NHWC layout; head conv weights
are OIHW (`compat.tree_from_reference` converts a reference head).

Two places where torch would differ from JAX unless told otherwise:

* ``jax.image.resize(..., "nearest")`` samples at half-pixel centres,
  which is ``F.interpolate(mode="nearest-exact")``; ``mode="nearest"``
  agrees only when the output size is a multiple of the input's.
* ``jax.lax.top_k`` puts the lower index first among equal values, and
  the decode's zeroed non-peaks tie on every frame; a stable descending
  sort gives that order, ``torch.topk`` does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.adc import clip


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Head hyperparameters (kept lite: one shared 3×3, three 1×1s)."""

    head_channels: int = 32
    max_dets: int = 8  # top-k peaks per frame (shape-stable decode)
    score_thresh: float = 0.3  # host-side filter before track association
    prior_logit: float = -2.19  # heatmap bias init: sigmoid ≈ 0.1 prior


def _conv_init(gen, k, cin, cout):
    fan_in = k * k * cin
    return torch.randn((cout, cin, k, k), generator=gen) * (
        2.0 / fan_in) ** 0.5


def init_detect_head(generator: torch.Generator, in_channels: int,
                     dcfg: DetectConfig, *, device) -> dict[str, Any]:
    """Head weights drawn from ``generator`` (a CPU generator: the same
    seed gives the same weights on any device)."""
    ch = dcfg.head_channels

    def layer(k, cin, cout, bias):
        return {"w": _conv_init(generator, k, cin, cout).to(device),
                "b": torch.full((cout,), bias, device=device)}

    return {"shared": layer(3, in_channels, ch, 0.0),
            "heatmap": layer(1, ch, 1, dcfg.prior_logit),
            "size": layer(1, ch, 2, 0.0),
            "offset": layer(1, ch, 2, 0.0)}


def _conv(x, p):
    """NCHW stride-1 SAME conv (odd kernels: symmetric padding)."""
    return F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)


def det_grid(stem_spatial: int) -> int:
    """Detection-grid side for a given P²M stem resolution: the backbone
    pools 32× below the stem, so the lite head nearest-upsamples the
    final feature map to stem/2 (56² at paper geometry)."""
    return max(1, stem_spatial // 2)


def apply_detect_head(det_params: dict, feats: torch.Tensor,
                      grid: int) -> dict[str, torch.Tensor]:
    """(B, h, w, C) backbone features → raw head outputs on the
    ``grid``×``grid`` detection grid (pre-decode), NHWC."""
    z = F.interpolate(feats.permute(0, 3, 1, 2), size=(grid, grid),
                      mode="nearest-exact")
    z = torch.relu(_conv(z, det_params["shared"]))
    return {name: torch.sigmoid(_conv(z, det_params[name])).permute(
        0, 2, 3, 1) for name in ("heatmap", "size", "offset")}


def decode_detections(outs: dict[str, torch.Tensor],
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Peak decode: (boxes (B, k, 4) normalized x0y0x1y1, scores (B, k)).

    3×3 local-max NMS on the heatmap (a peak survives iff it equals its
    neighborhood max), then the top k of the flattened grid, ties to the
    lower index; shape-stable, no host sync.
    """
    hm = outs["heatmap"][..., 0]  # (B, h, w)
    b, h, w = hm.shape
    local_max = F.max_pool2d(hm[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(hm == local_max, hm, torch.zeros_like(hm))
    kk = min(k, h * w)  # tiny smoke grids can undercut the requested k
    scores, idx = torch.sort(peaks.reshape(b, h * w), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :kk], idx[:, :kk]
    ys, xs = idx // w, idx % w  # (B, kk)

    def gather_bk(m):  # (B, h, w, 2) → (B, kk, 2)
        flat = m.reshape(b, h * w, 2)
        return torch.gather(flat, 1, idx[..., None].expand(b, kk, 2))

    off = gather_bk(outs["offset"])
    wh = gather_bk(outs["size"])
    cx = (xs.to(torch.float32) + off[..., 0]) / w
    cy = (ys.to(torch.float32) + off[..., 1]) / h
    boxes = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                         cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)
    if kk < k:  # pad to the contracted (B, k, ·) shape; score 0 never
        boxes = F.pad(boxes, (0, 0, 0, k - kk))  # survives the host filter
        scores = F.pad(scores, (0, k - kk))
    return boxes, scores


# ------------------------------------------------------------------ training


def render_targets(boxes: np.ndarray, h: int, w: int) -> dict[str, np.ndarray]:
    """Ground-truth maps for one frame's (N, 4) normalized boxes:
    gaussian-splatted heatmap, size/offset at center cells, and the
    center-cell mask the regression losses are gated by."""
    hm = np.zeros((h, w, 1), np.float32)
    size = np.zeros((h, w, 2), np.float32)
    off = np.zeros((h, w, 2), np.float32)
    mask = np.zeros((h, w, 1), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for x0, y0, x1, y1 in np.asarray(boxes, np.float32):
        bw, bh = max(x1 - x0, 1e-4), max(y1 - y0, 1e-4)
        cx, cy = (x0 + x1) / 2 * w, (y0 + y1) / 2 * h
        ix, iy = min(int(cx), w - 1), min(int(cy), h - 1)
        sigma = max(1.0, (bw * w + bh * h) / 8.0)
        g = np.exp(-(((xx - ix) ** 2 + (yy - iy) ** 2) / (2 * sigma**2)))
        hm[..., 0] = np.maximum(hm[..., 0], g)
        size[iy, ix] = [bw, bh]
        off[iy, ix] = [cx - ix, cy - iy]
        mask[iy, ix] = 1.0
    return {"heatmap": hm, "size": size, "offset": off, "mask": mask}


def detect_loss(outs: dict[str, torch.Tensor],
                targets: dict[str, torch.Tensor]) -> torch.Tensor:
    """Penalty-reduced focal loss on the heatmap + masked L1 on
    size/offset (CenterNet Eq. 1/2/3), mean over the batch."""
    eps = 1e-6
    p = clip(outs["heatmap"], eps, 1.0 - eps)
    t = targets["heatmap"]
    pos = (t >= 1.0 - 1e-6).to(p.dtype)
    focal_pos = -pos * ((1 - p) ** 2) * torch.log(p)
    focal_neg = -(1 - pos) * ((1 - t) ** 4) * (p**2) * torch.log(1 - p)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    loss = (focal_pos + focal_neg).sum() / n_pos
    m = targets["mask"]
    m_sum = torch.clamp(m.sum(), min=1.0)
    loss = loss + (torch.abs(outs["size"] - targets["size"]) * m).sum() / m_sum
    loss = loss + (torch.abs(outs["offset"] - targets["offset"])
                   * m).sum() / m_sum
    return loss
