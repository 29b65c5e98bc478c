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
  change what is written;
* threaded: the arrays' sha256 run on a pool of threads (hashlib lets
  go of the GIL), beside the archive's write on save; restore reads the
  archive's members side by side, each hashed as it lands;
* sharded: given ``shardings`` (the state's `NamedSharding` tree, as
  `shardings_for` gives it), every rank enters ``save``, each leaf's
  global tensor is assembled from the ranks' parts
  (`collectives.whole_tree`), and rank 0 writes it: the same files as a
  single process's.  ``restore_latest(template, shardings=...)`` is a
  barrier (rank 0's write is on disk before any rank reads), then reads
  the global arrays and gives each rank its part by the *current*
  shardings, which need not be the saved run's (the reference's
  "elastic" restore: TP 2 → FSDP 2 or one process).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.pytree import flatten_with_names
from repro_torch.tree import tree_leaves


_WORKERS = min(8, os.cpu_count() or 1)


def _sha256(a: np.ndarray) -> str:
    """sha256 of ``a.tobytes()``, without that copy of the array."""
    flat = np.ascontiguousarray(a).reshape(-1)
    return hashlib.sha256(flat.view(np.uint8)).hexdigest()


def _read_member(path: Path, name: str) -> tuple[np.ndarray, str]:
    """One array of the archive at ``path`` and its sha256 (each call
    opens the archive, so calls run side by side)."""
    with np.load(path) as npz:
        arr = npz[name]
    return arr, _sha256(arr)


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


def _gathered_to_host(state: dict, shardings) -> dict | None:
    """Rank 0's host copy of every leaf of ``state``, whole: each tensor
    leaf's parts gathered by its sharding a leaf at a time (every rank
    runs the same collectives, in path order); None on other ranks."""
    from repro_torch.parallel import collectives as col

    split = dict(flatten_with_names(shardings))
    first = _rank() == 0
    flat = {}
    for path, leaf in flatten_with_names(state):
        sh = split.get(path)
        if isinstance(leaf, torch.Tensor) and sh is not None \
                and not sh.is_fully_replicated:
            leaf = col.whole_tree({"x": leaf}, {"x": sh})["x"]
        if first:
            flat[path] = _to_host(leaf)
    return flat if first else None


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


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
             *, blocking: bool = False, shardings=None) -> None:
        """Write ``state`` (this rank's parts, with ``shardings``: every
        rank calls, rank 0 writes the global tree)."""
        # Snapshot to host synchronously, write async.
        if shardings is None:
            flat = {path: _to_host(leaf)
                    for path, leaf in flatten_with_names(state)}
        else:
            flat = _gathered_to_host(state, shardings)
            if flat is None:  # not rank 0: its parts are in rank 0's copy
                return
        self.wait()

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            with ThreadPoolExecutor(_WORKERS) as pool:
                digests = {path: pool.submit(_sha256, a)
                           for path, a in flat.items()}
                np.savez(tmp / "arrays.npz", **flat)
                manifest = {
                    "step": step,
                    "arrays": {
                        path: {
                            "shape": list(a.shape),
                            "dtype": str(a.dtype),
                            "sha256": digests[path].result(),
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

    def _load(self, step: int, template: dict,
              shardings=None) -> tuple[dict, dict] | None:
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        archive = path / "arrays.npz"
        with np.load(archive) as npz:
            names = list(npz.files)
        if any(name not in names for name in manifest["arrays"]):
            return None
        with ThreadPoolExecutor(_WORKERS) as pool:
            read = dict(zip(names, pool.map(
                lambda name: _read_member(archive, name), names)))
        flat = {name: arr for name, (arr, _) in read.items()}
        for name, meta in manifest["arrays"].items():
            if read[name][1] != meta["sha256"]:
                return None  # corrupt → caller falls back
        del read

        template_flat = dict(flatten_with_names(template))
        tensors = [t for t in tree_leaves(template)
                   if isinstance(t, torch.Tensor)]
        default = tensors[0].device if tensors else torch.device("cpu")
        if shardings is not None:  # each rank's part, by the current plan
            split = dict(flatten_with_names(shardings))
            flat = {name: (split[name].local(arr)
                           if isinstance(template_flat.get(name), torch.Tensor)
                           and name in split else arr)
                    for name, arr in flat.items()}
        placed = {name: _place(arr if arr.flags.c_contiguous
                               else np.ascontiguousarray(arr),
                               template_flat.get(name), default)
                  for name, arr in flat.items()}
        return (_in_order_of(_unflatten(placed), template),
                manifest.get("extra", {}))

    def restore_latest(self, template: dict, *,
                       shardings=None) -> tuple[dict, dict] | None:
        """Restore newest valid checkpoint, skipping corrupt ones.  With
        ``shardings`` (every rank calls): a barrier, then this rank's
        parts of the global arrays by them, ``template`` its parts."""
        self.wait()
        if shardings is not None and dist.is_initialized():
            dist.barrier()
        for step in reversed(self.steps()):
            try:
                result = self._load(step, template, shardings)
            except Exception:  # unreadable/corrupt archive → try older
                result = None
            if result is not None:
                return result
        return None
