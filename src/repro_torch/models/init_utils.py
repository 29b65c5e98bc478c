"""Parameter construction with attached logical axes; port of
`repro.models.init_utils`.

``make(generator, shape, axes)`` returns a :class:`Spec` carrying both the
initialized tensor and its logical axis names; ``split_tree`` separates a
nested dict of Specs into (params, axes) trees.  Draws come from an
explicit `torch.Generator` on the target device, so a large model is
initialized where it lives and never passes through the host.  With
``abstract=True``, or inside `abstract_init`, the value is a tensor on
the ``meta`` device: a shape and a dtype, no storage
(`families.validate_slot_layout` reads the axes; `launch.specs` builds
whole cells so).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

_ABSTRACT = threading.local()


@contextlib.contextmanager
def abstract_init():
    """Inside this context every `make` returns a ``meta`` tensor, so a
    family's ``init`` allocates nothing: init at production scale for the
    cell specs."""
    prev = getattr(_ABSTRACT, "on", False)
    _ABSTRACT.on = True
    try:
        yield
    finally:
        _ABSTRACT.on = prev


@dataclasses.dataclass
class Spec:
    value: Any  # torch.Tensor (a meta tensor under abstract init)
    axes: tuple


def make(
    generator: torch.Generator | None,
    shape: tuple[int, ...],
    axes: tuple,
    *,
    init: str = "normal",
    scale: float | None = None,
    dtype: Any = torch.float32,
    abstract: bool = False,
    device=None,
) -> Spec:
    """Create an initialized parameter (or an abstract stand-in).

    init: "normal" (fan-in scaled), "zeros", "ones", "constant" (scale
    everywhere).  The tensor lies on ``generator``'s device, or on
    ``device`` for the inits that draw nothing.
    """
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    if abstract or getattr(_ABSTRACT, "on", False):
        return Spec(torch.empty(shape, dtype=dtype, device="meta"), axes)
    if generator is not None:
        device = generator.device
    if device is None:
        raise ValueError("make needs a generator or a device")
    if init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    elif init == "constant":
        v = torch.full(shape, scale, dtype=dtype, device=device)
    else:  # fan-in normal
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in ** -0.5
        v = (torch.randn(shape, generator=generator, device=device)
             * s).to(dtype)
    return Spec(v, axes)


def split_tree(tree: Any) -> tuple[Any, Any]:
    """Nested dict of Specs → (params tree, axes tree)."""
    if isinstance(tree, Spec):
        return tree.value, tree.axes
    params, axes = {}, {}
    for k, v in tree.items():
        params[k], axes[k] = split_tree(v)
    return params, axes


class KeyGen:
    """The reference's stream of subkeys: here one generator, whose draws
    follow each other in call order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def __call__(self) -> torch.Generator:
        return self.generator
