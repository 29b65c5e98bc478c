"""Weights drawn on the device from the seed, in the port's parameter-tree
keys, at the init scales of the port (a frozen copy).  The program and
the reference get the same tensors; each leaf has a generator of its own,
seeded from (seed, leaf index), so any leaf can be drawn again alone."""
from __future__ import annotations

import numpy as np
import torch


def _leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0])


class Draw:
    """Draws leaf after leaf, one generator call a leaf."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.index = 0

    def _gen(self) -> torch.Generator:
        self.index += 1
        return torch.Generator(self.device).manual_seed(
            _leaf_seed(self.seed, self.index))

    def normal(self, shape, std: float) -> torch.Tensor:
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type == "meta":  # shapes only
            return out
        return out.normal_(0.0, std, generator=self._gen())

    def uniform(self, shape, bound: float) -> torch.Tensor:
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type == "meta":
            return out
        return out.uniform_(-bound, bound, generator=self._gen())

    def full(self, shape, value: float) -> torch.Tensor:
        self.index += 1  # keeps each leaf's index whatever draws
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


# ------------------------------------------------------------ MobileNetV2


def block_schedule(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(expansion, channels, repeats, stride) a stage, the width applied and
    the last stage cut by ``last_block_div``."""
    out = []
    blocks = cfg["blocks"]
    for idx, (t, c, n, s) in enumerate(blocks):
        c = int(round(c * cfg["width"]))
        if idx == len(blocks) - 1 and cfg["last_block_div"] > 1:
            c = max(8, c // cfg["last_block_div"])
        out.append((t, c, n, s))
    return out


def head_channels(cfg: dict) -> int:
    return int(round(cfg["head_channels"] * max(1.0, cfg["width"])))


def mnv2(seed: int, cfg: dict, device) -> tuple[dict, dict]:
    """(params, BN state) of the P²M MobileNetV2 in the port's keys: conv
    weights OIHW He-normal, the P²M ``theta`` (k, k, C, Co) uniform in
    ±sqrt(3/fan_in), ``fc`` normal 0.01, BN γ 1, β 0, running mean 0,
    var 1."""
    d = Draw(seed, device)

    def conv(k, cin, cout, groups=1):
        fan_in = k * k * cin // groups
        return d.normal((cout, cin // groups, k, k), (2.0 / fan_in) ** 0.5)

    def bn(c):
        return ({"gamma": d.full((c,), 1.0), "beta": d.full((c,), 0.0)},
                {"mean": d.full((c,), 0.0), "var": d.full((c,), 1.0)})

    p2m = cfg["p2m"]
    k, cin, cout = p2m["kernel"], p2m["in_channels"], p2m["out_channels"]
    params = {"stem": {
        "theta": d.uniform((k, k, cin, cout), (3.0 / (k * k * cin)) ** 0.5),
        "bn_gamma": d.full((cout,), 1.0), "bn_beta": d.full((cout,), 0.0)}}
    state = {"stem": {"bn_mean": d.full((cout,), 0.0),
                      "bn_var": d.full((cout,), 1.0)}}
    cin = cout
    bidx = 0
    for t, c, n, _ in block_schedule(cfg):
        for _ in range(n):
            hidden = cin * t
            blk, bst = {}, {}
            if t != 1:
                g, s = bn(hidden)
                blk["expand"] = {"w": conv(1, cin, hidden), "bn": g}
                bst["expand"] = {"bn": s}
            g, s = bn(hidden)
            blk["dw"] = {"w": conv(3, hidden, hidden, hidden), "bn": g}
            bst["dw"] = {"bn": s}
            g, s = bn(c)
            blk["project"] = {"w": conv(1, hidden, c), "bn": g}
            bst["project"] = {"bn": s}
            params[f"block{bidx}"], state[f"block{bidx}"] = blk, bst
            bidx += 1
            cin = c
    ch = head_channels(cfg)
    g, s = bn(ch)
    params["head"] = {"w": conv(1, cin, ch), "bn": g}
    state["head"] = {"bn": s}
    params["fc"] = {"w": d.normal((ch, cfg["num_classes"]), 0.01),
                    "b": d.full((cfg["num_classes"],), 0.0)}
    return params, state


# ------------------------------------------------------------------ RWKV-6


def rwkv6(seed: int, cfg: dict, device) -> dict:
    """The RWKV-6 tree in the port's keys, every layer's leaf stacked on a
    leading axis: fan-in normal products (std fan_in^-1/2), the table
    d^-1/4, the low-rank B factors 0.01, ``w0`` −0.6, ``u`` 0.5, the norms'
    scales 0 (applied as 1 + scale), the GroupNorm 1 and 0, μ 0."""
    d = Draw(seed, device)
    L, dm, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    r = cfg["lora_dim"]
    h, hd, v = cfg["n_heads"], cfg["head_dim"], cfg["vocab"]

    def prod(shape):
        return d.normal(shape, shape[-2] ** -0.5)

    def mix(n):
        return {"mu": d.full((L, n, dm), 0.0),
                "lora_a": prod((L, dm, n * r)),
                "lora_b": d.normal((L, n, r, dm), 0.01)}

    layers = {
        "att_norm": {"scale": d.full((L, dm), 0.0)},
        "ffn_norm": {"scale": d.full((L, dm), 0.0)},
        "att": {
            "mix": mix(5),
            "wr": prod((L, dm, dm)), "wk": prod((L, dm, dm)),
            "wv": prod((L, dm, dm)), "wg": prod((L, dm, dm)),
            "wo": prod((L, dm, dm)),
            "w0": d.full((L, h, hd), -0.6),
            "w_lora_a": prod((L, dm, r)),
            "w_lora_b": d.normal((L, r, dm), 0.01),
            "u": d.full((L, h, hd), 0.5),
            "gn_scale": d.full((L, h, hd), 1.0),
            "gn_bias": d.full((L, h, hd), 0.0),
        },
        "ffn": {"mix": mix(2), "wk": prod((L, dm, ff)),
                "wv": prod((L, ff, dm)), "wr": prod((L, dm, dm))},
    }
    embed = {"table": d.normal((v, dm), dm ** -0.25),
             "final_norm": {"scale": d.full((dm,), 0.0)},
             "head": prod((dm, v))}
    return {"embed": embed, "layers": layers}


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in the tree's key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def n_params(tree) -> int:
    return sum(t.numel() for _, t in leaves(tree))
