"""One rank of the port's distributed tests, run as its own process
(JAX-free: it imports torch and ``repro_torch`` only).

    python tests/torch_dist_worker.py JOB.json RANK WORLD

``JOB.json`` holds ``{"rendezvous": "file://...", "device": "cpu" or
"cuda", "tasks": [...]}``; every rank runs the tasks in order over a
process group (gloo: on the CPU, or several ranks sharing one card) and
rank 0 writes each task's ``result``. Tasks:

- ``step``: one `make_train_step` step of a smoke config (float32) on a
  mesh, from the reference's weights (``weights``: an npz of its tree,
  `save_tree`) and a batch (``batch``: an npz), plain, with
  ``grad_compression`` or with ``microbatches``; writes the metrics and
  the gathered parameters, moments, master weights and error state in
  the reference's layout (`checkpoint.bridge.tree_to_numpy`).
- ``refuse``: the step of each of ``archs`` on a mesh; writes the
  `ValueError` each raises.
- ``save`` / ``restore``: a step, then its state saved on the mesh; or
  the state restored on the mesh from ``ckpt`` and written gathered.
- ``psum``: `optim.compression.int8_psum` of this rank's row of
  ``inputs`` over ``over``; writes each rank's result, and the bytes
  the call sent (``result``.json).
- ``compress``: `compress_with_feedback` of this rank's shards of whole
  gradients and error state; writes the gathered results.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import numpy as np


def save_tree(path, tree):
    """A tree of dicts and lists of arrays -> one npz, keys the leaves'
    paths ("[i]" marks a list index)."""
    flat = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{pre}[{i}]/")
            if not t:
                flat[f"{pre}[]"] = np.zeros(0)
        else:
            flat[pre[:-1]] = np.asarray(t)
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path):
    """The tree `save_tree` wrote."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            if parts[-1] == "[]":
                continue
            node[parts[-1]] = z[key]

    def fix(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.startswith("[") for k in t):
            return [fix(t[f"[{i}]"]) for i in range(len(t))]
        return {k: (fix(v) if v != {} else []) if isinstance(v, dict)
                else v for k, v in t.items()}
    return fix(root)


def _config(task):
    from repro_torch.configs import get_config
    cfg = get_config(task["arch"], smoke=True)
    return dataclasses.replace(cfg, dtype=task.get("dtype", "float32"),
                               **task.get("replace", {}))


def _mesh(task, meshes, device):
    from repro_torch.parallel.shard import Mesh
    key = (tuple(task["mesh"]), tuple(task["axes"]))
    if key not in meshes:
        meshes[key] = Mesh(task["mesh"], task["axes"], device)
    return meshes[key]


def _specs(task, cfg, mesh):
    from repro_torch.launch import specs as SP
    return SP.train_specs(cfg, mesh, task.get("gc", False))


def _state(task, cfg, mesh):
    """The reference's weights as this rank's shards, and a fresh
    optimizer state."""
    from repro_torch.checkpoint import bridge
    from repro_torch.training.step import init_opt_state
    params = bridge.params_from_numpy(load_tree(task["weights"]), cfg,
                                      mesh.device, mesh=mesh,
                                      specs=_specs(task, cfg, mesh)["params"])
    opt = init_opt_state(params, cfg,
                         grad_compression=task.get("gc", False))
    return params, opt


def _step(task, cfg, mesh, params, opt, specs):
    import torch

    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.shard import mesh_context
    from repro_torch.training.step import make_train_step
    step = make_train_step(cfg, AdamWConfig(**task["opt"]),
                           microbatches=task.get("mb", 1),
                           grad_compression=task.get("gc", False),
                           specs=specs)
    batch = {k: torch.from_numpy(v).to(mesh.device) for k, v in
             load_tree(task["batch"]).items()}
    with mesh_context(mesh):
        return step(params, opt, batch)


def _gathered(cfg, mesh, params, opt, gc: bool) -> dict:
    """{params, m, v, master, grad_err?} whole, in the reference's layout
    (numpy)."""
    from repro_torch.checkpoint import bridge
    from repro_torch.launch import specs as SP
    full = SP.gather_tree({"params": params, "opt": opt},
                          SP.train_specs(cfg, mesh, gc), mesh)
    out = {"params": bridge.tree_to_numpy(full["params"], cfg)}
    for k in ("m", "v", "master"):
        out[k] = bridge.tree_to_numpy(full["opt"]["adam"][k], cfg)
    if gc:
        out["grad_err"] = bridge.tree_to_numpy(full["opt"]["grad_err"])
    return out


def task_step(task, mesh, rank):
    cfg = _config(task)
    params, opt = _state(task, cfg, mesh)
    mesh.stats.clear()
    params, opt, m = _step(task, cfg, mesh, params, opt,
                           _specs(task, cfg, mesh))
    stats = {f"{op}:{'+'.join(ax)}": np.asarray(v, np.float64)
             for (op, ax), v in mesh.stats.items()}
    out = _gathered(cfg, mesh, params, opt, task.get("gc", False))
    if rank == 0:
        out["metrics"] = {k: np.float64(float(v)) for k, v in m.items()}
        out["stats"] = stats
        save_tree(task["result"], out)


def task_refuse(task, mesh, rank):
    from repro_torch.launch.specs import param_shapes
    msgs = {}
    for arch in task["archs"]:
        cfg = _config({"arch": arch})
        try:
            _step({"opt": {}, "batch": task["batch"]}, cfg, mesh,
                  param_shapes(cfg), {"adam": {}}, None)
            msgs[arch] = "no error"
        except ValueError as e:
            msgs[arch] = f"ValueError: {e}"
    if rank == 0:
        with open(task["result"], "w") as f:
            json.dump(msgs, f)


def task_save(task, mesh, rank):
    from repro_torch.checkpoint import save
    from repro_torch.launch import specs as SP
    cfg = _config(task)
    gc = task.get("gc", False)
    params, opt = _state(task, cfg, mesh)
    specs = _specs(task, cfg, mesh)
    params, opt, _ = _step(task, cfg, mesh, params, opt, specs)
    save(task["ckpt"], 1, {"params": params, "opt": opt}, mesh=mesh,
         specs=specs)
    out = _gathered(cfg, mesh, params, opt, gc)
    if rank == 0:
        save_tree(task["result"], out)


def task_restore(task, mesh, rank):
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch import specs as SP
    cfg = _config(task)
    gc = task.get("gc", False)
    params, opt = _state(task, cfg, mesh)
    step = latest_step(task["ckpt"])
    ck = restore(task["ckpt"], step, {"params": params, "opt": opt},
                 mesh=mesh, specs=SP.train_specs(cfg, mesh, gc))
    out = _gathered(cfg, mesh, ck["params"], ck["opt"], gc)
    if rank == 0:
        out["step"] = np.int64(step)
        save_tree(task["result"], out)


def task_psum(task, mesh, rank):
    import torch

    from repro_torch.optim.compression import int8_psum
    x = np.load(task["inputs"])[mesh.index(task["over"])[0]]
    mesh.stats.clear()
    got = int8_psum(torch.from_numpy(x).to(mesh.device), task["over"], mesh)
    sent = {f"{op}:{'+'.join(ax)}": v[1] for (op, ax), v in
            mesh.stats.items()}
    got = mesh.all_gather(got[None], mesh.axis_names, 0)
    if rank == 0:
        np.save(task["result"], got.cpu().numpy())
        with open(task["result"] + ".json", "w") as f:
            json.dump(sent, f)


def task_compress(task, mesh, rank):
    from repro_torch.checkpoint import bridge
    from repro_torch.launch import specs as SP
    from repro_torch.optim import compression
    cfg = _config(task)
    specs = SP.train_specs(cfg, mesh, grad_compression=True)
    grads = bridge.params_from_numpy(load_tree(task["grads"]), cfg,
                                     mesh.device, mesh=mesh,
                                     specs=specs["params"])
    err = bridge.opt_state_from_numpy(
        {"adam": {"m": load_tree(task["grads"]), "v": load_tree(
            task["grads"]), "master": load_tree(task["grads"]), "step": 0},
         "grad_err": load_tree(task["err"])}, cfg, mesh.device,
        mesh=mesh, specs=specs["opt"])["grad_err"]
    comp, new = compression.compress_with_feedback(
        grads, err, cfg, mesh, specs["opt"]["grad_err"])
    full = SP.gather_tree({"g": comp, "e": new},
                          {"g": specs["params"],
                           "e": specs["opt"]["grad_err"]}, mesh)
    if rank == 0:
        save_tree(task["result"], {
            "grads": bridge.tree_to_numpy(full["g"], cfg),
            "err": bridge.tree_to_numpy(full["e"])})


TASKS = {"step": task_step, "refuse": task_refuse, "save": task_save,
         "restore": task_restore, "psum": task_psum,
         "compress": task_compress}


def main(job_path: str, rank: int, world: int) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    from repro_torch.parallel.shard import init_distributed
    device = torch.device(job.get("device", "cpu"))
    init_distributed(device, rank=rank, world=world,
                     init_method=job["rendezvous"],
                     timeout_s=job.get("timeout_s", 120))
    meshes: dict = {}
    try:
        for task in job["tasks"]:
            TASKS[task["kind"]](task, _mesh(task, meshes, device), rank)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
