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

Elasticity (the reference's restore onto another mesh): under a mesh
(``mesh`` and the tree's ``specs``) `save` gathers each leaf from its
shards and rank 0 writes the same format, and `restore` reads the whole
arrays and gives each rank its shards. A checkpoint saved on one mesh
restores on any other, or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.tree import leaves, paths, unflatten
from repro_torch.parallel.shard import (full_shape, gather_leaf, spec_leaves,
                                        take_shard)


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # npz has no bf16: widen losslessly
        t = t.float()
    return t.numpy()


def _spec_list(specs, n: int) -> list:
    out = spec_leaves(specs)
    if len(out) != n:
        raise ValueError(f"{len(out)} specs for {n} leaves")
    return out


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra_meta: dict | None = None, mesh=None, specs=None) -> str:
    """Atomically save a tree checkpoint. Returns the final path. Under
    ``mesh`` every rank calls it with its shards (``specs`` theirs); rank
    0 writes the whole arrays."""
    if mesh is not None:
        xs = leaves(tree)
        whole = []
        for x, spec in zip(xs, _spec_list(specs, len(xs))):
            g = gather_leaf(x, spec, mesh)
            whole.append(_to_np(g) if mesh.rank == 0 else None)
            del g
        if mesh.rank == 0:
            _write(ckpt_dir, step, tree, whole, keep, extra_meta)
        mesh.barrier()
        return os.path.join(ckpt_dir, f"step_{step:08d}")
    return _write(ckpt_dir, step, tree, [_to_np(x) for x in leaves(tree)],
                  keep, extra_meta)


def _write(ckpt_dir, step, tree, arrays, keep, extra_meta) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"leaf_{i}": a for i, a in enumerate(arrays)}
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


def restore(ckpt_dir: str, step: int, like_tree, *, mesh=None, specs=None):
    """Restore into the structure of ``like_tree``: each leaf as a tensor
    of that leaf's dtype on its device. Under ``mesh`` the leaves of
    ``like_tree`` are this rank's shards (``specs`` theirs) and each
    rank takes its shards of the whole arrays, read one leaf at a
    time."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    like = leaves(like_tree)
    spec = [None] * len(like) if mesh is None else \
        _spec_list(specs, len(like))
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        if len(z.files) != len(like):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, model "
                             f"expects {len(like)}")
        for i, (x, sp) in enumerate(zip(like, spec)):
            a = z[f"leaf_{i}"]
            want = tuple(x.shape) if sp is None else \
                full_shape(x.shape, sp, mesh)
            if tuple(a.shape) != want:
                raise ValueError(f"shape mismatch {a.shape} vs {want}")
            if sp is not None:
                a = np.ascontiguousarray(take_shard(a, sp, mesh))
            out.append(torch.from_numpy(a).to(device=x.device,
                                              dtype=x.dtype))
    return unflatten(like_tree, out)
