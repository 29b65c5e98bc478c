"""Checkpointing: npz archive + JSON manifest, async save thread, content
hashing, atomic commit; port of `repro.checkpoint.manager`, with the
same layout on disk (a checkpoint of either restores into the other):

    <dir>/step_<N>/
        manifest.json   (paths, shapes, dtypes, sha256, extra state)
        arrays.npz      (flat path→array archive)

* atomic: a checkpoint directory is committed by renaming it from a
  ``.tmp`` suffix only after all bytes are written, so a crash never
  leaves a half checkpoint that `restore_latest` would pick up;
* verified: restore checks each array's sha256 against the manifest and
  falls back to the previous checkpoint on corruption;
* placed: restore puts each array on its template leaf's device and
  dtype (a template leaf that is a host int, as a train state's
  ``step``, gives an int), and its keys in the template's order; an
  array with no template leaf goes to the device of the template's
  first tensor;
* async: ``save`` copies every leaf to host memory, then writes on a
  worker thread; ``wait()`` joins it.  The copy is taken before
  ``save`` returns, so a step that updates the state in place cannot
  change what is written.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import flatten_with_names
from repro_torch.tree import tree_leaves


def _unflatten(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _in_order_of(tree, template):
    """``tree`` with its keys in ``template``'s order, then any keys the
    template lacks.  A restored state then walks its leaves in the
    order the saved one did, so sums over them (the gradients' global
    norm) round the same way."""
    if not isinstance(tree, dict) or not isinstance(template, dict):
        return tree
    keys = [k for k in template if k in tree] + [k for k in tree
                                                  if k not in template]
    return {k: _in_order_of(tree[k], template.get(k)) for k in keys}


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later writes to it do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _place(arr: np.ndarray, template, default_device):
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    if isinstance(template, int):
        return int(arr)
    return torch.from_numpy(arr).to(default_device)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save

    def save(self, step: int, state: dict, extra: dict | None = None,
             *, blocking: bool = False) -> None:
        # Snapshot to host synchronously, write async.
        flat = {path: _to_host(leaf)
                for path, leaf in flatten_with_names(state)}
        self.wait()

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **flat)
            manifest = {
                "step": step,
                "arrays": {
                    path: {
                        "shape": list(a.shape),
                        "dtype": str(a.dtype),
                        "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                    }
                    for path, a in flat.items()
                },
                "extra": extra or {},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------- restore

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def _load(self, step: int, template: dict) -> tuple[dict, dict] | None:
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as npz:
            flat = {k: npz[k] for k in npz.files}
        for name, meta in manifest["arrays"].items():
            if name not in flat:
                return None
            if hashlib.sha256(flat[name].tobytes()).hexdigest() != meta["sha256"]:
                return None  # corrupt → caller falls back

        template_flat = dict(flatten_with_names(template))
        tensors = [t for t in tree_leaves(template)
                   if isinstance(t, torch.Tensor)]
        default = tensors[0].device if tensors else torch.device("cpu")
        placed = {name: _place(arr, template_flat.get(name), default)
                  for name, arr in flat.items()}
        return (_in_order_of(_unflatten(placed), template),
                manifest.get("extra", {}))

    def restore_latest(self, template: dict) -> tuple[dict, dict] | None:
        """Restore newest valid checkpoint, skipping corrupt ones."""
        self.wait()
        for step in reversed(self.steps()):
            try:
                result = self._load(step, template)
            except Exception:  # unreadable/corrupt archive → try older
                result = None
            if result is not None:
                return result
        return None
