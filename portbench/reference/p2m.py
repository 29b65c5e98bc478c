"""The P²M in-pixel layer (arXiv:2203.04737 §3–4), plainly.

Every multiply of the layer's convolution is the pixel's transfer
``g(w, x) = Σ_{i,j≥1} a_ij w^i x^j`` (the weight's sign applied by the
correlated double sampling), its coefficients fitted by least squares to
the pixel's surface.  So

    raw[m, n] = Σ_k sign(W[k, n]) g(|W[k, n]|, X[m, k])
              = Σ_j (X^∘j @ Ŵ_j)[m, n],  Ŵ_j = Σ_i a_ij sign(W) ∘ |W|^∘i,

and the column ADC's counter gives a shifted ReLU saturating at full
scale, counted in whole LSBs when deployed.  At deployment the BN affine
``A·y + B`` is folded: ``A`` into the weights (clipped to the
transistor's [−1, 1]) and ``B`` into the counter's pre-load; the weights
are then quantized per output channel to 8 bits and the pre-load to the
LSB grid (§4.2)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pixel_coefficients(pm: dict) -> np.ndarray:
    """(degree_w, degree_x) coefficients a_ij of the least-squares fit of
    the pixel surface ``v_max(1+sat)u/(1+sat·u) + sf_leak·x·w·(1−x)``,
    ``u = w·x``, on a grid × grid sweep of [0, 1]²."""
    dw, dx, n = pm["degree_w"], pm["degree_x"], pm["grid"]
    ws = np.linspace(0.0, 1.0, n)
    wg, xg = np.meshgrid(ws, ws, indexing="ij")
    w, x = wg.ravel(), xg.ravel()
    u = w * x
    v = (pm["v_max"] * (1.0 + pm["sat"]) * u / (1.0 + pm["sat"] * u)
         + pm["sf_leak"] * x * w * (1.0 - x))
    a = np.stack([w**i * x**j for i in range(1, dw + 1)
                  for j in range(1, dx + 1)], axis=-1)
    coef, *_ = np.linalg.lstsq(a, v, rcond=None)
    return coef.reshape(dw, dx)


def patches(images: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(B, H, W, C) → (B·Ho·Wo, C·k·k) patches, channel-major as
    `F.unfold` orders them."""
    cols = F.unfold(images.permute(0, 3, 1, 2), k, stride=s)  # (B, Ckk, L)
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


def flat_weights(theta: torch.Tensor) -> torch.Tensor:
    """θ (k, k, C, Co) → (C·k·k, Co) in the patches' order."""
    k1, k2, c, co = theta.shape
    return theta.permute(2, 0, 1, 3).reshape(c * k1 * k2, co)


def raw_conv(x: torch.Tensor, w: torch.Tensor, coeffs) -> torch.Tensor:
    """Σ_k sign(w) g(|w|, x) for patches x (M, K), weights w (K, N)."""
    a = torch.as_tensor(np.asarray(coeffs), dtype=w.dtype, device=w.device)
    dw, dx = a.shape
    sgn, aw = torch.sign(w), torch.abs(w)
    raw = None
    xp = x
    for j in range(dx):
        what = sum(a[i, j] * sgn * aw ** (i + 1) for i in range(dw))
        term = xp @ what
        raw = term if raw is None else raw + term
        if j + 1 < dx:
            xp = xp * x
    return raw


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def adc_full_scale(p2m: dict) -> tuple[float, int]:
    """(volts a count, counts at full scale) of the N-bit column ADC."""
    max_count = (1 << p2m["n_bits"]) - 1
    return 1.0 / max_count, max_count


def stem_train(theta, gamma, beta, mean, var, images, p2m: dict, coeffs,
               train: bool):
    """Train form: conv of g → BN (batch statistics and the running ones'
    update with ``train``) → the ADC's saturating ReLU.  Returns (out (B,
    Ho, Wo, Co), new running mean, new running var)."""
    k, s = p2m["kernel"], p2m["stride"]
    b, h, w_, _ = images.shape
    ho, wo = (h - k) // s + 1, (w_ - k) // s + 1
    w = _clip(flat_weights(theta), -1.0, 1.0)
    raw = raw_conv(patches(images, k, s), w, coeffs)
    mom = p2m["bn_momentum"]
    if train:
        bm = raw.mean(0)
        bv = ((raw - bm) ** 2).mean(0)
        new_mean = mom * mean + (1 - mom) * bm.detach()
        new_var = mom * var + (1 - mom) * bv.detach()
    else:
        bm, bv, new_mean, new_var = mean, var, mean, var
    y = gamma * (raw - bm) / torch.sqrt(bv + p2m["bn_eps"]) + beta
    lsb, max_count = adc_full_scale(p2m)
    y = _clip(y, 0.0, max_count * lsb)
    return y.reshape(b, ho, wo, -1), new_mean, new_var


def deploy(theta, gamma, beta, mean, var, p2m: dict, quant_bits: int | None):
    """(weights (C·k·k, Co), pre-load in volts) of the folded and quantized
    deploy stem."""
    inv = 1.0 / torch.sqrt(var + p2m["bn_eps"])
    a, shift = gamma * inv, beta - gamma * mean * inv
    w = torch.clamp(_clip(flat_weights(theta), -1.0, 1.0) * a[None, :],
                    -1.0, 1.0)
    if quant_bits is None:
        return w, shift
    qmax = float(2 ** (quant_bits - 1) - 1)
    scale = torch.clamp(w.abs().amax(0, keepdim=True) / qmax, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    w = w + (q * scale - w)
    lsb = torch.tensor(1.0 / (2**quant_bits - 1), device=w.device)
    shift = torch.round(shift / lsb) * (1.0 / (2**quant_bits - 1))
    return w, shift


def stem_deploy(w, shift, images, p2m: dict, coeffs) -> torch.Tensor:
    """The deployed stem: the counter's ``clip(round(raw/Δ) + round(B/Δ),
    0, 2^N − 1)``, read back in volts.  (B, Ho, Wo, Co)."""
    k, s = p2m["kernel"], p2m["stride"]
    b, h, w_, _ = images.shape
    ho, wo = (h - k) // s + 1, (w_ - k) // s + 1
    lsb_v, max_count = adc_full_scale(p2m)
    lsb = torch.tensor(lsb_v, dtype=torch.float32, device=images.device)
    raw = raw_conv(patches(images, k, s), w, coeffs)
    counts = torch.round(raw / lsb) + torch.round(shift / lsb)
    out = torch.clamp(counts, 0.0, float(max_count)) * lsb_v
    return out.reshape(b, ho, wo, -1)
