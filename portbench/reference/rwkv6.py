"""RWKV-6 "Finch" (arXiv:2404.05892 §4), plainly, over whole sequences
from a zero state.

Time mix: token shift with the data-dependent lerp (μ plus a low-rank
tanh term, one stream each for r, k, v, g and the decay), the decay
``w_t = exp(−exp(ω_t))``, ``ω_t = ω₀ + tanh(x_w A) B``, the WKV
recurrence per head

    y_t = r_t (S_{t−1} + diag(u) k_tᵀ v_t),  S_t = diag(w_t) S_{t−1} + k_tᵀ v_t

one token at a time, a GroupNorm a head (eps 64e-5), the SiLU gate and
the output product.  Channel mix: token shift, squared-ReLU key and the
sigmoid receptance.  Pre-norms and the final norm are RMSNorm scaled by
``1 + scale``, and the log decay is clamped to [−5, −1e−6], as the
configuration states (its ``assumed``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms(x, scale, eps):
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * inv * (1.0 + scale)


def shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def lerp_streams(mix: dict, x, xx):
    """(B, T, n, d): x + (xx − x)(μ_i + tanh(x A)_i B_i) for each stream i."""
    n, r = mix["mu"].shape[0], mix["lora_b"].shape[1]
    lo = torch.tanh(x @ mix["lora_a"]).reshape(*x.shape[:2], n, r)
    m = mix["mu"] + torch.einsum("btnr,nrd->btnd", lo, mix["lora_b"])
    return x[:, :, None] + (xx - x)[:, :, None] * m


def wkv(r, k, v, lw, u):
    """The recurrence, token by token; (B, T, H, D) in, y out."""
    b, t, h, d = r.shape
    s = r.new_zeros(b, h, d, d)
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, i],
                               s + u[..., None] * kv))
        s = torch.exp(lw[:, i])[..., None] * s + kv
    return torch.stack(ys, 1)


def time_mix(p: dict, x, cfg: dict):
    b, t, dm = x.shape
    h, hd = cfg["n_heads"], cfg["head_dim"]
    st = lerp_streams(p["mix"], x, shift(x))
    xr, xk, xv, xg, xw = st.unbind(2)
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"])
    omega = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
                       ).reshape(b, t, h, hd)
    lw = torch.clamp(-torch.exp(omega), cfg["log_decay_min"],
                     cfg["log_decay_max"])
    y = wkv(r, k, v, lw, p["u"])
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) / torch.sqrt(var + cfg["groupnorm_eps"])
    y = (y * p["gn_scale"] + p["gn_bias"]).reshape(b, t, dm)
    return (y * g) @ p["wo"]


def channel_mix(p: dict, x):
    xr, xk = lerp_streams(p["mix"], x, shift(x)).unbind(2)
    return torch.sigmoid(xr @ p["wr"]) * (torch.relu(xk @ p["wk"]) ** 2
                                         @ p["wv"])


def layer(x, lp: dict, cfg: dict):
    eps = cfg["norm_eps"]
    x = x + time_mix(lp["att"], rms(x, lp["att_norm"]["scale"], eps), cfg)
    return x + channel_mix(lp["ffn"], rms(x, lp["ffn_norm"]["scale"], eps))


def _layer_params(layers: dict, i: int) -> dict:
    if isinstance(layers, dict):
        return {k: _layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def hidden(params: dict, tokens, cfg: dict, remat: bool = False):
    """Final hidden states (B, T, d), normed, before the head."""
    x = params["embed"]["table"][tokens]
    for i in range(cfg["n_layers"]):
        lp = _layer_params(params["layers"], i)
        if remat:
            x = checkpoint(layer, x, lp, cfg, use_reentrant=False)
        else:
            x = layer(x, lp, cfg)
    return rms(x, params["embed"]["final_norm"]["scale"], cfg["norm_eps"])


def logits(params: dict, tokens, cfg: dict, remat: bool = False):
    return hidden(params, tokens, cfg, remat) @ params["embed"]["head"]


def loss(params: dict, tokens, targets, cfg: dict, remat: bool = True):
    """Mean next-token cross-entropy."""
    lg = logits(params, tokens, cfg, remat)
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, targets[..., None])[..., 0]).mean()
