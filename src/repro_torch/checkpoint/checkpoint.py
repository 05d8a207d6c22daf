"""Step-atomic checkpointing with async write and restore onto a device.

The port of `repro/checkpoint/checkpoint.py`, with its layout:
<dir>/step_<n>/manifest.json + arrays.npz

  * the manifest records the flattened key paths, shapes, dtypes and the
    step; the key paths are the ones `jax.tree_util.keystr` spells for
    the reference's trees (`.params['embed']`,
    `.params['blocks'][0]['ln1']`, `.opt.m[...]`, `.opt.step`), so a
    checkpoint written by either package restores in the other;
  * writes go to a temp dir and an atomic rename, so a crash mid-write
    never corrupts the latest checkpoint; the oldest beyond `keep` go;
  * `AsyncCheckpointer.save` copies every leaf to host memory
    synchronously and writes in a background thread.  The snapshot is a
    copy: on the CPU `Tensor.numpy()` shares the tensor's storage, which
    the next step could change under the writer;
  * `restore(..., device=)` places every leaf on the target device in
    `like`'s dtype.  A sharded leaf (a DTensor) is saved whole and comes
    back split as `like`'s is.

NumPy has no bfloat16, and the port does not need `ml_dtypes`: a bf16
leaf is saved widened to float32 (exact), the manifest keeps
"bfloat16", and `restore` casts back to `like`'s dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.sharding import gather
from repro_torch.models.tree import as_tree


def _items(tree, path: str = ""):
    """(key path, leaf) pairs in the reference's order and spelling: a
    NamedTuple's fields as `.name`, dict keys as `['key']` (sorted), a
    sequence's items as `[i]`; `None` has no leaves."""
    tree = as_tree(tree)
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of `leaf` as numpy, and its dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        a = np.array(leaf, copy=True)
        return a, str(a.dtype)
    t = gather(leaf.detach())          # a DTensor whole
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), "bfloat16"
    return t.to("cpu", copy=True).numpy(), str(t.dtype).replace("torch.", "")


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    arrays, dtypes = {}, {}
    for key, leaf in _items(tree):
        arrays[key], dtypes[key] = _host(leaf)
    return arrays, dtypes


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    arrays, dtypes = _flatten(tree)
    return _write(ckpt_dir, step, arrays, keep, dtypes)


def _write(ckpt_dir: str, step: int, arrays: dict[str, np.ndarray],
           keep: int, dtypes: Optional[dict[str, str]] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    dtypes = dtypes or {}
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": dtypes.get(k, str(v.dtype))}
                   for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


class AsyncCheckpointer:
    """Snapshot synchronously, write in a background thread.  After each
    save, `snapshot_s` holds the seconds of the host copy and, once the
    writer is done, `write_s` those of the write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        t0 = time.perf_counter()
        arrays, dtypes = _flatten(tree)        # host snapshot (blocks)
        self.snapshot_s = time.perf_counter() - t0
        self.write_s = None

        def write():
            t = time.perf_counter()
            _write(self.ckpt_dir, step, arrays, self.keep, dtypes)
            self.write_s = time.perf_counter() - t

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, *, device=None):
    """Rebuild the tree `like` from a checkpoint: every leaf in the dtype
    of `like`'s leaf, on `device` (default: where that leaf is).  An `LM`
    in `like` comes back as a new `LM` of the same config."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def build(t, prefix):
            tree = as_tree(t)
            if hasattr(tree, "_fields"):
                return type(tree)(*[build(getattr(tree, f), f"{prefix}.{f}")
                                    for f in tree._fields])
            if isinstance(tree, dict):
                out = {k: build(v, f"{prefix}[{k!r}]")
                       for k, v in tree.items()}
            elif isinstance(tree, (tuple, list)):
                out = tuple(build(v, f"{prefix}[{i}]")
                            for i, v in enumerate(tree))
            elif tree is None:
                return None
            else:
                return _leaf(data[prefix], tree, device)
            return type(t)(t.cfg, out) if tree is not t else out

        return build(like, "")


def _leaf(arr: np.ndarray, like, device) -> torch.Tensor:
    t = torch.from_numpy(arr)          # a fresh array, read from the file
    if isinstance(like, torch.Tensor):
        t = t.to(device=device if device is not None else like.device,
                 dtype=like.dtype)
        if isinstance(like, DTensor):  # split again as `like` is
            t = distribute_tensor(t, like.device_mesh, like.placements)
        return t
    return t.to(device=device)
