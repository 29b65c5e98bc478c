"""MobileNetV2 for Visual Wake Words with the P²M first layer, plainly
(arXiv:1801.04381 §3–4; arXiv:2203.04737 §5.1): inverted residual blocks
(1×1 expansion, 3×3 depthwise, 1×1 linear projection, each with BN and,
but for the projection, ReLU6), the residual where stride is 1 and the
width is kept, a 1×1 head, global mean pool and a linear classifier.
Convolutions pad as TensorFlow's SAME, as the reproduced model does.
NHWC images in, float32 throughout."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import p2m as p2m_ref
from portbench.weights import block_schedule


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, groups=1):
    k = w.shape[-1]
    t, b = _same(x.shape[2], k, stride)
    l, r = _same(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride, groups=groups)


def bn(x, p, s, train: bool, momentum: float, eps: float):
    """BN of an NCHW tensor; with ``train`` on the batch's statistics
    (population variance) and the running ones' update."""
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean((0, 2, 3))
        new = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
               "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var, new = s["mean"], s["var"], s
    c = (lambda v: v[None, :, None, None])
    return (x - c(mean)) / torch.sqrt(c(var) + eps) * c(p["gamma"]) \
        + c(p["beta"]), new


def relu6(x):
    return torch.minimum(torch.maximum(x, x.new_zeros(())),
                         x.new_full((), 6.0))


def backbone(params, state, x, cfg: dict, train: bool):
    """Blocks, head, pool and classifier on NHWC stem activations: (logits,
    new BN state of the blocks and head)."""
    mom, eps = cfg["bn_momentum"], cfg["bn_eps"]
    x = x.permute(0, 3, 1, 2)
    new: dict = {}
    bidx = 0
    cin = x.shape[1]
    for t, c, n, s in block_schedule(cfg):
        for i in range(n):
            stride = s if i == 0 else 1
            blk, bst = params[f"block{bidx}"], state[f"block{bidx}"]
            nst = {}
            y = x
            if t != 1:
                y, nst_e = bn(conv(y, blk["expand"]["w"]), blk["expand"]["bn"],
                              bst["expand"]["bn"], train, mom, eps)
                nst["expand"] = {"bn": nst_e}
                y = relu6(y)
            y, nst_d = bn(conv(y, blk["dw"]["w"], stride, y.shape[1]),
                          blk["dw"]["bn"], bst["dw"]["bn"], train, mom, eps)
            nst["dw"] = {"bn": nst_d}
            y = relu6(y)
            y, nst_p = bn(conv(y, blk["project"]["w"]), blk["project"]["bn"],
                          bst["project"]["bn"], train, mom, eps)
            nst["project"] = {"bn": nst_p}
            if stride == 1 and cin == c:
                y = y + x
            x = y
            new[f"block{bidx}"] = nst
            bidx += 1
            cin = c
    x, nst_h = bn(conv(x, params["head"]["w"]), params["head"]["bn"],
                  state["head"]["bn"], train, mom, eps)
    new["head"] = {"bn": nst_h}
    x = relu6(x).mean((2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"], new


def forward_train(params, state, images, cfg: dict, coeffs,
                  train: bool = True):
    """Train-form model: (logits, new state)."""
    st = state["stem"]
    pp = params["stem"]
    x, m, v = p2m_ref.stem_train(pp["theta"], pp["bn_gamma"], pp["bn_beta"],
                                 st["bn_mean"], st["bn_var"], images,
                                 cfg["p2m"], coeffs, train)
    logits, new = backbone(params, state, x, cfg, train)
    return logits, {"stem": {"bn_mean": m, "bn_var": v}, **new}


def deploy_stem(params, state, cfg: dict):
    pp, st = params["stem"], state["stem"]
    return p2m_ref.deploy(pp["theta"], pp["bn_gamma"], pp["bn_beta"],
                          st["bn_mean"], st["bn_var"], cfg["p2m"],
                          cfg["deploy_quant_bits"])


def probs_deploy(params, state, images, cfg: dict, coeffs, stem=None):
    """Class probabilities of the deployed model (folded, quantized stem;
    BN on the running statistics)."""
    w, shift = stem if stem is not None else deploy_stem(params, state, cfg)
    x = p2m_ref.stem_deploy(w, shift, images, cfg["p2m"], coeffs)
    logits, _ = backbone(params, state, x, cfg, train=False)
    return torch.softmax(logits, -1)


def softmax_ce(logits, labels):
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).mean()
