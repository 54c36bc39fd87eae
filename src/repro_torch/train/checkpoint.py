"""Checkpointing: atomic, integrity-checked, async-capable save/restore.

The counterpart of ``repro.train.checkpoint``, with its layout on disk:
<dir>/step_<N>/
    manifest.json   — step, and per array its shape, dtype and sha256
    arrays.npz      — flattened leaves keyed by path ("/" written as "|")

The port's trees keep the layers in a list, so its keys read
``params/layers/0/attn/wq`` where the reference's stacked tree reads
``params/layers/attn/wq``: a checkpoint written by one package does not load
into the other. Tensors are written as numpy arrays (bf16 as f32, which
restores exactly) and restored onto the device and type of the tree they
load into, requiring grad where its leaf does.

Fault-tolerance properties:
  * atomic publish: written to ``step_<N>.tmp`` then renamed — a crash
    mid-save never corrupts the latest checkpoint;
  * integrity: every array hashed; restore verifies before handing it out;
  * async: ``save_async`` copies every tensor to host memory before it
    returns (later in-place updates do not reach the snapshot) and writes in
    a background thread so the train loop never blocks on disk;
  * ``latest_step``/``restore`` pick up the newest *complete* checkpoint, so
    restart-after-failure is one call.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.tree import leaves_with_paths, path_key


def _host(x) -> np.ndarray:
    """A host copy of a leaf that later writes to ``x`` do not change."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.array(x, copy=True)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path_key(path): _host(leaf) for path, leaf in leaves_with_paths(tree)}


def _unflatten(like, flat: Dict[str, np.ndarray], path=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, path + (i,)) for i, v in enumerate(like))
    key = path_key(path)
    arr = flat[key]
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(like.shape)}")
        t = torch.from_numpy(arr.copy()).to(device=like.device, dtype=like.dtype)
        return t.requires_grad_(True) if like.requires_grad else t
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr)  # a python scalar leaf (the step counter)


def save(ckpt_dir: str, step: int, state: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {"step": step, "arrays": {}}
    for k, v in flat.items():
        manifest["arrays"][k] = {
            "shape": list(v.shape),
            "dtype": str(v.dtype),
            "sha256": hashlib.sha256(v.tobytes()).hexdigest(),
        }
    np.savez(os.path.join(tmp, "arrays.npz"), **{k.replace("/", "|"): v for k, v in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


_PENDING: Dict[str, threading.Thread] = {}
_PENDING_LOCK = threading.Lock()


def save_async(ckpt_dir: str, step: int, state: Any) -> threading.Thread:
    """Snapshot every leaf to host memory now; write to disk in the background."""
    host_state = _flatten(state)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_state), daemon=True)
    t.start()
    with _PENDING_LOCK:
        _PENDING[ckpt_dir] = t
    return t


def wait_pending(ckpt_dir: Optional[str] = None) -> None:
    with _PENDING_LOCK:
        todo = [(d, t) for d, t in _PENDING.items() if ckpt_dir is None or d == ckpt_dir]
    for d, t in todo:
        t.join()
        with _PENDING_LOCK:
            if _PENDING.get(d) is t:
                del _PENDING[d]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load the checkpoint into the structure of ``state_like`` (verifying
    shapes and hashes). Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    for k, meta in manifest["arrays"].items():
        h = hashlib.sha256(flat[k].tobytes()).hexdigest()
        if h != meta["sha256"]:
            raise IOError(f"checkpoint corruption detected in {k} at step {step}")
    return _unflatten(state_like, flat), step
