"""Tree utilities; port of `repro.common.pytree`.

Parameter containers are nested dicts with tensor (or numpy) leaves, as
in `repro_torch.tree`.  These helpers give named flattening (for
checkpoint manifests) and size accounting (for memory budgeting).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.tree import tree_leaves


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, dict)


def flatten_with_names(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ``(dotted.path, leaf)`` pairs in deterministic (sorted) order."""
    if _is_leaf(tree):
        yield prefix or "<root>", tree
        return
    for key in sorted(tree.keys()):
        path = f"{prefix}.{key}" if prefix else str(key)
        yield from flatten_with_names(tree[key], path)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """Like `repro_torch.tree.tree_map`, but ``fn`` receives the dotted
    path too."""
    if _is_leaf(tree):
        return fn(prefix or "<root>", tree)
    return {
        key: tree_map_with_path(fn, tree[key],
                                f"{prefix}.{key}" if prefix else str(key))
        for key in tree.keys()
    }


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree)
               if hasattr(x, "shape"))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total byte footprint across all leaves."""
    return sum(int(np.prod(x.shape)) * _itemsize(x.dtype)
               for x in tree_leaves(tree)
               if hasattr(x, "shape") and hasattr(x, "dtype"))


def param_count(tree: Any) -> int:
    """Alias of :func:`tree_size` for readability at call sites."""
    return tree_size(tree)


def assert_trees_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise if any floating leaf holds NaN or Inf."""
    for path, leaf in flatten_with_names(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.all(np.isfinite(arr))
        if bad:
            raise AssertionError(f"{name}[{path}] contains non-finite values")
