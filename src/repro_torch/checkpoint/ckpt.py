"""Atomic, async checkpointing in the JAX package's on-disk layout.  The port
of `repro.checkpoint.ckpt`.

Layout:  <dir>/step_<N>/
            manifest.json        — leaf names, shapes, dtypes
            <leaf-name>.npy      — one file per leaf

Leaf names follow the same convention (`distributed.sharding.path_str`
over `repro_torch._tree` paths: dict keys, ``.field`` for named-tuple
fields, ``/`` replaced by ``.``), so a checkpoint that the JAX `ckpt.save`
writes restores here and the other way round.

  * **atomic**: writes go to ``step_<N>.tmp`` and are renamed only after the
    manifest lands, so a killed run never leaves a half checkpoint,
  * **async**: `AsyncCheckpointer.save_async` copies the tensors to the
    host, then writes on a background thread while training continues;
    `wait` joins it and raises what the write raised,
  * `restore` places every leaf on one ``device``;
    `distributed.elastic.restore_on_mesh` places them on a mesh as
    DTensors (the JAX function's target shardings),
  * retention of the newest `keep` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import repro_torch
from repro_torch._tree import (tree_flatten_with_path, tree_map,
                               tree_map_with_path)
from repro_torch.distributed.sharding import path_str

__all__ = ["MANIFEST", "save", "AsyncCheckpointer", "list_steps",
           "latest_step", "restore"]

MANIFEST = "manifest.json"


def _leaf_name(path) -> str:
    return path_str(path).replace("/", ".")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for path, x in tree_flatten_with_path(tree):
        name = _leaf_name(path)
        arr = _to_numpy(x)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot to the host, then write in the background; `wait()` joins
    and re-raises a failed write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = tree_map(_to_numpy, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree)
                self._gc()
            except Exception as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, abstract_tree: Any,
            device=None) -> Any:
    """Load a checkpoint into the structure of ``abstract_tree`` (tensors on
    any device, "meta" included, whose shapes and dtypes the leaves must
    take), every leaf on ``device`` (None means the card)."""
    dev = repro_torch.resolve_device(device)
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, MANIFEST)) as f:
        manifest = json.load(f)
    names = {leaf["name"] for leaf in manifest["leaves"]}

    def load(path, ab):
        name = _leaf_name(path)
        if name not in names:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(src, name + ".npy"))
        if tuple(arr.shape) != tuple(ab.shape):
            raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                             f"expected {tuple(ab.shape)}")
        return torch.from_numpy(arr).to(device=dev, dtype=ab.dtype)

    return tree_map_with_path(load, abstract_tree)
