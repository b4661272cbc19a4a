"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic step-tagged saves, retention, manifest validation.

Layout:
    <dir>/step_00000100.tmp/...      (being written)
    <dir>/step_00000100/manifest.json + arrays.npz

Atomicity: write into a .tmp dir, fsync the manifest, then os.replace — a
crash mid-save never corrupts the newest valid checkpoint. `latest_step`
only considers directories with a valid manifest (leaf-count check).

A tree is nested dicts and lists of tensors (`core.tree`); leaves are
saved whole, in the order of `core.tree.leaves` (bfloat16 widened to
float32, losslessly), and restored onto the dtype and device of the
corresponding leaf of a tree of the same structure.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.tree import leaves, paths, unflatten


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # npz has no bf16: widen losslessly
        t = t.float()
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra_meta: dict | None = None) -> str:
    """Atomically save a tree checkpoint. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"leaf_{i}": _to_np(x) for i, x in enumerate(leaves(tree))}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "bytes": int(sum(a.nbytes for a in arrays.values())),
        "paths": paths(tree),
        "time": time.time(),
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):           # a re-save of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)              # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(valid_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def valid_steps(ckpt_dir: str) -> list[int]:
    """Steps with a structurally valid checkpoint (manifest + arrays)."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        path = os.path.join(ckpt_dir, d)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                m = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                if len(z.files) != m["n_leaves"]:
                    continue
            out.append(int(m["step"]))
        except (OSError, ValueError, KeyError):
            continue            # partial/corrupt -> ignored
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf as a tensor
    of that leaf's dtype on its device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    like = leaves(like_tree)
    if len(arrays) != len(like):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, model expects {len(like)}")
    for a, x in zip(arrays, like):
        if tuple(a.shape) != tuple(x.shape):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(x.shape)}")
    return unflatten(like_tree, [
        torch.from_numpy(a).to(device=x.device, dtype=x.dtype)
        for a, x in zip(arrays, like)])
