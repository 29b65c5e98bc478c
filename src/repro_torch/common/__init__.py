"""Shared utilities: tree helpers and dtype policies; port of
`repro.common`."""
from repro_torch.common.precision import DEFAULT_POLICY, Policy, cast_floating
from repro_torch.common.pytree import (
    flatten_with_names,
    param_count,
    tree_bytes,
    tree_map_with_path,
    tree_size,
)

__all__ = [
    "tree_size",
    "tree_bytes",
    "tree_map_with_path",
    "param_count",
    "flatten_with_names",
    "Policy",
    "DEFAULT_POLICY",
    "cast_floating",
]
