"""Checkpointing: atomic ``.npz`` save and restore, asynchronous writes
and retention.

Mirrors ``repro/checkpoint/store.py`` and writes its layout:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (the tree structure,
the sorted keys, each key's dtype name and shape), written to a temp dir
and renamed, so a half-written checkpoint is never visible. Keys are the
leaves' ``/``-joined key paths in jax's order (``repro_torch.tree``).

Dtypes numpy's npz cannot hold (``bfloat16``, ``float8_e4m3fn``,
``float8_e5m2``) are stored as flat ``uint8`` views of their bytes, named
in the manifest, as the reference stores them; torch makes and reads the
views itself (``Tensor.view(torch.uint8)``), so a checkpoint written by
either package restores in the other bit for bit.

There is no sharding on one device: ``restore`` places every leaf on
``device``, and ``restore_resharded`` is the same with each leaf cast to
the dtype of ``like``'s.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_path, tree_map

__all__ = ["save", "restore", "restore_resharded", "latest_step", "CheckpointManager"]

# dtypes numpy's npz format cannot round-trip natively -> byte views
_EXOTIC = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def _to_savable(leaf) -> tuple[np.ndarray, str, list[int]]:
    """A leaf as ``(array npz can hold, dtype name, shape)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            # flat byte view (0-d safe); shape restored from the manifest
            return t.reshape(-1).view(torch.uint8).numpy(), name, list(t.shape)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name, list(arr.shape)


def _from_savable(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        return torch.from_numpy(arr.copy()).view(_EXOTIC[dtype_name]).reshape(shape)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Atomic synchronous save. Returns the final checkpoint path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        flat, treedef = tree_flatten_with_path(tree)
        savable, dtypes, shapes = {}, {}, {}
        for k, leaf in flat:
            savable[k], dtypes[k], shapes[k] = _to_savable(leaf)
        np.savez(tmp / "arrays.npz", **savable)
        manifest = {
            "step": step,
            "treedef": str(treedef),
            "keys": sorted(savable),
            "dtypes": dtypes,
            "shapes": shapes,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
        if (p / "arrays.npz").exists())
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int, like: Any,
            device: str | torch.device | None = None) -> Any:
    """Restore into the structure of ``like`` (a matching tree), every
    leaf a tensor on ``device`` (default ``cuda``; raises without it) in
    the dtype the checkpoint stored."""
    dev = resolve_device(device)
    base = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((base / "manifest.json").read_text())
    dtypes, shapes = manifest["dtypes"], manifest["shapes"]
    flat_like, treedef = tree_flatten_with_path(like)
    leaves = []
    with np.load(base / "arrays.npz") as data:
        for key, leaf in flat_like:
            t = _from_savable(data[key], dtypes[key], tuple(shapes[key]))
            expect = getattr(leaf, "shape", None)
            if expect is not None and tuple(t.shape) != tuple(expect):
                raise ValueError(f"{key}: checkpoint {tuple(t.shape)} != {tuple(expect)}")
            leaves.append(t.to(dev))
    return treedef.unflatten(leaves)


def restore_resharded(ckpt_dir: str | Path, step: int, like: Any,
                      device: str | torch.device | None = None) -> Any:
    """Elastic restore: the checkpoint, whatever mesh wrote it, placed on
    ``device`` with each leaf in the dtype of ``like``'s. The reference
    places leaves per a sharding tree; on one device that is a move."""
    dev = resolve_device(device)
    host = restore(ckpt_dir, step, like, device="cpu")
    return tree_map(lambda t, leaf: t.to(device=dev, dtype=leaf.dtype), host, like)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    """Asynchronous checkpointing off the training critical path, with
    retention.

    ``save_async`` copies the tree to host memory before it returns (so
    later in-place updates cannot reach the checkpoint) and writes it in
    a daemon thread; ``wait`` joins the outstanding write and raises its
    error, if any. Keeps the last ``keep`` checkpoints.
    """

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host = tree_map(_host_copy, tree)  # snapshot before mutation

        def work():
            try:
                save(self.dir, step, host)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
