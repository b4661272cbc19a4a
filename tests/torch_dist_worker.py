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
- ``encode``: `models.encdec.encode` of the batch's ``frames`` on the
  mesh from the reference's weights as this rank's shards; every rank
  writes ``result``.<rank>.npz: its block of the output and where it
  lies (``rows``, ``positions``).
- ``save`` / ``restore``: a step, then its state saved on the mesh; or
  the state restored on the mesh from ``ckpt`` and written gathered.
- ``psum``: `optim.compression.int8_psum` of this rank's row of
  ``inputs`` over ``over``; writes each rank's result, and the bytes
  the call sent (``result``.json).
- ``compress``: `compress_with_feedback` of this rank's shards of whole
  gradients and error state; writes the gathered results.
- ``serve``: `make_serve_fns` under the mesh from the reference's
  weights as this rank's shards: the prompts (``batch``: an npz of
  ``tokens`` (B, S) and ``stream`` (steps, B), the tokens each decode
  step feeds; an encoder-decoder's ``frames``) prefilled (``chunk``:
  through `make_chunk_prefill_fn`;
  ``paged``: pages from a `HostPageAllocator` of every row, the rank's
  rows written into its tables), or with ``ref_state`` (an npz of the
  reference's state after its prefill) that state carried into this
  rank's shards (`serve_state_from_numpy`); then each step of
  ``stream`` teacher-forced. Every rank writes ``result``.<rank>.npz:
  every step's logits, this rank's state in the reference's layout,
  where its shards lie (``where``), the pages it allocated, the bytes
  each step sent and each kernel's launches (on the card).
  ``rules`` "ssm" runs it under `SSM_RULES`; ``kv_cache_dtype`` a page
  format or a per-layer plan; ``ckpt``: the weights restored from a
  checkpoint in training's layout and re-cut to the serving layout (the
  restored tree itself refused by the prefill: ``refused``). ``slices``
  says where the rank's shard of every leaf of every contiguous or
  recurrent layer lies; ``params`` what the rank holds of the weights
  (`_held_params`); ``prefill_sent`` / ``decode_sent`` the bytes the
  prefill and the last decode step sent by collective.
- ``save_params``: the reference's weights as this rank's shards in
  training's layout, saved as a checkpoint at ``ckpt``.
- ``recurrent``: `models.recurrent_mesh.decode` over the first
  ``layer_kind`` layer's state of a smoke config (``state_quant``: from
  the int8 initial state), its weights and inputs from ``inputs``;
  writes the rank's outputs, rows, state and its shards' slices.
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
    if task.get("granularity"):
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, granularity=task["granularity"]))
    return dataclasses.replace(cfg, dtype=task.get("dtype", "float32"),
                               **task.get("replace", {}))


def _mesh(task, meshes, device):
    from repro_torch.parallel.shard import Mesh
    key = (tuple(task["mesh"]), tuple(task["axes"]))
    if key not in meshes:
        meshes[key] = Mesh(task["mesh"], task["axes"], device)
    return meshes[key]


def _rules(task):
    """The task's override of the logical rules ("ssm": `SSM_RULES`)."""
    from repro_torch.parallel.shard import SSM_RULES
    return SSM_RULES if task.get("rules") == "ssm" else None


def _specs(task, cfg, mesh):
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.shard import mesh_context
    with mesh_context(mesh, _rules(task)):
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
    with mesh_context(mesh, _rules(task)):
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
    out["layout"] = _layout(task, cfg, mesh)
    if rank == 0:
        out["metrics"] = {k: np.float64(float(v)) for k, v in m.items()}
        out["stats"] = stats
        save_tree(task["result"], out)


def _layout(task, cfg, mesh) -> dict:
    """The step's activation layout under the task's rules: the axes of
    the rows and of the positions."""
    from repro_torch.parallel.shard import Layout, mesh_context
    B, S = load_tree(task["batch"])["tokens"].shape
    with mesh_context(mesh, _rules(task)):
        lay = Layout.of(mesh, B, S, cfg.d_model)
    return {"batch": np.array("+".join(lay.batch)),
            "seq": np.array("+".join(lay.seq))}


def task_encode(task, mesh, rank):
    import torch

    from repro_torch.models import encdec
    from repro_torch.parallel.shard import Layout, mesh_context
    cfg = _config(task)
    params, _ = _state(task, cfg, mesh)
    frames = torch.from_numpy(load_tree(task["batch"])["frames"]).to(
        mesh.device)
    with mesh_context(mesh):
        lay = Layout.of(mesh, *frames.shape)
        with torch.no_grad():
            out = encdec.encode(params, frames, cfg,
                                specs=_specs(task, cfg, mesh)["params"])
    save_tree(f"{task['result']}.{rank}.npz", {
        "out": out.float().cpu().numpy(),
        "rows": np.array(lay.rows().indices(lay.B)[:2]),
        "positions": np.array(lay.positions().indices(lay.S)[:2])})


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


def allocate_rows(alloc, rows: int, blocks: int) -> np.ndarray:
    """A page table (rows, blocks) from ``alloc`` (a `HostPageAllocator`
    of either package): a few pages taken and every other one given back
    first, so the rows' pages are out of order; then each row's, row by
    row."""
    warm = alloc.alloc(5)
    alloc.release(warm[::2])
    return np.array([alloc.alloc(blocks) for _ in range(rows)], np.int32)


def _where(state, specs, mesh, cfg, B: int, max_len: int) -> dict:
    """Where this rank's shards of the first attention layer lie in the
    whole state: rows, and slots and scale rows, or kv heads, as [start,
    stop) (none in a stack without attention)."""
    from repro_torch.parallel.shard import shard_slices
    first = [i for i, c in enumerate(state)
             if hasattr(c, "pool") or hasattr(c, "k_q")]
    if not first:
        return {}
    c, sp = state[first[0]], specs[first[0]]
    max_len = getattr(c, "max_len", max_len)      # a ring's slots
    span = lambda s, n: np.array(s.indices(n)[:2])
    if hasattr(c, "pool"):
        return {"rows": span(shard_slices(sp["page_table"], (B, 1),
                                          mesh)[0], B),
                "heads": span(shard_slices(
                    sp["pool"]["k_q"], (1, 1, cfg.n_kv_heads, 1),
                    mesh)[2], cfg.n_kv_heads)}
    nb = 1 if c.per_channel else max_len // c.block_size
    whole = (B, cfg.n_kv_heads, max_len, 1)
    return {"rows": span(shard_slices(sp["k_q"], whole, mesh)[0], B),
            "slots": span(shard_slices(sp["k_q"], whole, mesh)[2], max_len),
            "scales": span(shard_slices(sp["k_s"], (1, 1, nb, 1),
                                        mesh)[2], nb)}


def _slices(specs, whole, mesh) -> dict:
    """Where this rank's shard of each leaf of each contiguous or
    recurrent layer lies in the whole layer: {"<layer>.<field>": (ndim,
    2) [start, stop) a dim}."""
    from repro_torch.parallel.shard import shard_slices
    out = {}
    for i, (sp, c) in enumerate(zip(specs, whole)):
        if hasattr(c, "pool"):
            continue
        for f, spec in sp.items():
            shape = tuple(getattr(getattr(c, f), "shape", ()))
            out[f"{i}.{f}"] = np.array(
                [s.indices(n)[:2] for s, n in zip(
                    shard_slices(spec, shape, mesh), shape)],
                np.int64).reshape(len(shape), 2)
    return out


def task_serve(task, mesh, rank):
    import torch

    from repro_torch.checkpoint import bridge
    from repro_torch.core.paging import HostPageAllocator
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.shard import SSM_RULES, mesh_context
    from repro_torch.serving.engine import (make_chunk_prefill_fn,
                                            make_serve_fns)
    cfg = _config(task)
    rules = SSM_RULES if task.get("rules") == "ssm" else None
    with mesh_context(mesh, rules):
        pspecs = SP.serve_param_specs(cfg, mesh)
        tspecs = SP.param_specs(cfg, mesh)
    restored = None
    if task.get("ckpt"):        # saved in training's layout, then re-cut
        from repro_torch.checkpoint import latest_step, restore
        like = SP.init_shards(cfg, torch.Generator().manual_seed(0),
                              mesh.device, tspecs, mesh)
        restored = restore(task["ckpt"], latest_step(task["ckpt"]), like,
                           mesh=mesh, specs=tspecs)
        params = SP.refit_tree(restored, tspecs, pspecs, mesh)
    else:
        params = bridge.params_from_numpy(load_tree(task["weights"]), cfg,
                                          mesh.device, mesh=mesh,
                                          specs=pspecs)
    data = load_tree(task["batch"])
    toks = torch.from_numpy(data["tokens"]).to(mesh.device)
    stream = data["stream"]
    B, S = toks.shape
    paged = task.get("paged", False)
    kv = task.get("kv_cache_dtype", "int8")
    with mesh_context(mesh, rules):
        init, prefill, decode = make_serve_fns(
            cfg, max_len=task["max_len"], paged=paged,
            n_pages=task.get("n_pages"), kv_cache_dtype=kv,
            device=mesh.device)
        chunk = make_chunk_prefill_fn(cfg) if task.get("chunk") else None
        specs, whole = SP.serve_state_specs(
            cfg, B, task["max_len"], mesh, paged=paged,
            n_pages=task.get("n_pages"), kv_cache_dtype=kv)
    if restored is not None:    # training's layout is refused, unsent
        try:
            prefill(restored, toks, init(B))
            out_refused = False
        except ValueError:
            out_refused = True
    state = init(B)
    from repro_torch.launch.op_cost import tree_bytes
    state_bytes = np.int64(tree_bytes(state))
    if isinstance(state, dict):         # an encoder-decoder's two stacks
        out = {"where": {k: _where(state[k], specs[k], mesh, cfg, B,
                                   task["max_len"]) for k in state},
               "slices": {k: _slices(specs[k], whole[k], mesh)
                          for k in state}}
    else:
        out = {"where": _where(state, specs, mesh, cfg, B, task["max_len"]),
               "slices": _slices(specs, whole, mesh)}
    out["state_bytes"] = state_bytes
    if restored is not None:
        out["refused"] = np.bool_(out_refused)
    if paged:
        table = allocate_rows(HostPageAllocator(state[0].pool.k_q.shape[0]),
                              B, task["max_len"] // cfg.quant.block_size)
        r0, r1 = out["where"]["rows"]
        for c in state:
            c.page_table.copy_(torch.from_numpy(table[r0:r1]))
        out["pages"] = table
    from repro_torch.kernels import COUNTED
    launches0 = {f.__name__: f.launches for f in COUNTED}
    logits = []
    mesh.stats.clear()
    if task.get("ref_state"):
        bridge.serve_state_from_numpy(load_tree(task["ref_state"]), state,
                                      cfg, mesh, specs)
        out["carried"] = bridge.serve_state_to_numpy(state, cfg)
    elif chunk is not None:
        zeros = torch.zeros((B,), dtype=torch.int32, device=mesh.device)
        lg, state = chunk(params, toks, state, zeros,
                          torch.full_like(zeros, S),
                          torch.ones((B,), dtype=torch.bool,
                                     device=mesh.device))
        logits.append(lg)
    else:
        inputs = toks
        if "frames" in data:
            inputs = {"tokens": toks, "frames": torch.from_numpy(
                data["frames"]).to(mesh.device)}
        lg, state = prefill(params, inputs, state)
        logits.append(lg)
    out["prefill_sent"] = _sent(mesh)
    pos = torch.full((B,), S, dtype=torch.int32, device=mesh.device)
    sent = []
    for j in range(stream.shape[0]):
        mesh.stats.clear()
        tok = torch.from_numpy(stream[j][:, None]).to(mesh.device)
        lg, state = decode(params, tok, state, pos)
        logits.append(lg)
        sent.append(sum(v[1] for v in mesh.stats.values()))
        pos = pos + 1
    out["state"] = bridge.serve_state_to_numpy(state, cfg)
    out["logits"] = np.stack([lg.float().cpu().numpy() for lg in logits])
    out["sent"] = np.array(sent, np.int64)
    out["decode_sent"] = _sent(mesh)
    out["params"] = _held_params(params, pspecs, cfg, mesh)
    out["launches"] = {f.__name__: np.int64(f.launches
                                            - launches0[f.__name__])
                       for f in COUNTED}
    save_tree(f"{task['result']}.{rank}.npz", out)


def _sent(mesh) -> dict:
    """The bytes each collective sent since ``mesh.stats`` was cleared,
    by "op:axes"."""
    return {f"{op}:{'+'.join(ax)}": np.int64(v[1])
            for (op, ax), v in mesh.stats.items()}


def _held_params(params, specs, cfg, mesh) -> dict:
    """What this rank holds of the serving weights: the bytes of the
    storages its leaves use (each counted once), the bytes the serving
    specs give its shards (`launch.specs.shard_shapes`), and how many
    leaves the specs split (over axes of more than one rank) and how
    many of those it holds whole."""
    import math

    from repro_torch.core.tree import leaves
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.shard import spec_leaves
    seen, held = set(), 0
    for t in leaves(params):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            held += st.nbytes()
    split = whole = 0
    for t, full, sp in zip(leaves(params), leaves(SP.param_shapes(cfg)),
                           spec_leaves(specs), strict=True):
        if any(axes and mesh.index(axes)[1] > 1 for axes in sp):
            split += 1
            whole += tuple(t.shape) == tuple(full.shape)
    want = sum(math.prod(shape) * x.element_size() for x, shape in zip(
        leaves(SP.param_shapes(cfg)), SP.shard_shapes(cfg, specs, mesh)))
    return _held(held, want, split, whole)


def _held(held, want, split, whole) -> dict:
    return {"held_bytes": np.int64(held), "spec_bytes": np.int64(want),
            "split": np.int64(split), "split_whole": np.int64(whole)}


def task_save_params(task, mesh, rank):
    """The reference's weights as this rank's shards in training's layout
    (`launch.specs.param_specs`), saved as a checkpoint at ``ckpt``."""
    from repro_torch.checkpoint import bridge, save
    from repro_torch.launch import specs as SP
    cfg = _config(task)
    specs = SP.param_specs(cfg, mesh)
    params = bridge.params_from_numpy(load_tree(task["weights"]), cfg,
                                      mesh.device, mesh=mesh, specs=specs)
    save(task["ckpt"], 0, params, mesh=mesh, specs=specs)


def task_recurrent(task, mesh, rank):
    """The sharded decode of `models.recurrent_mesh` over one recurrent
    layer's state (the first of ``layer_kind``; ``state_quant``: from the
    int8 initial state), its weights (from ``inputs``) cut to this rank's
    shards of `launch.specs.serve_param_specs` and its seeded inputs;
    writes this rank's outputs, rows, state and where its shards lie, the
    bytes each step sent and what it holds of the weights."""
    import math

    import torch

    from repro_torch.launch import specs as SP
    from repro_torch.models import recurrent_mesh
    from repro_torch.models.transformer import serve_layout
    from repro_torch.parallel.shard import SSM_RULES, mesh_context
    cfg = _config(task)
    data = load_tree(task["inputs"])
    x = data["x"]
    B = x.shape[1]
    kind = task["layer_kind"]
    i = list(cfg.block_pattern).index(kind)
    sq = task["state_quant"]
    rules = SSM_RULES if task.get("rules") == "ssm" else None
    with mesh_context(mesh, rules):
        sp = SP.serve_param_specs(cfg, mesh)["layers"][i][kind]
        whole = {k: torch.from_numpy(v) for k, v in data["weights"].items()}
        p = {k: v.to(mesh.device) for k, v in SP.shard_tree(
            whole, sp, mesh).items()}
        specs, swhole = SP.serve_state_specs(cfg, B, 16, mesh)
        st = SP.init_serve_state(cfg, B, 16, mesh, device=mesh.device)[i]
        if sq and kind == "mlstm":
            st.C = torch.zeros(st.C.shape, dtype=torch.int8,
                               device=mesh.device)
        lay = serve_layout(mesh, cfg, B)
        rows = lay.rows()
        outs, sent = [], []
        for t in range(x.shape[0]):
            mesh.stats.clear()
            outs.append(recurrent_mesh.decode(
                kind, p, sp, torch.from_numpy(x[t][rows]).to(mesh.device),
                cfg, lay, st, state_quant=sq))
            sent.append(sum(v[1] for v in mesh.stats.values()))
    split = [k for k in p if any(a and mesh.index(a)[1] > 1
                                 for a in sp[k])]
    held = _held(sum(t.untyped_storage().nbytes() for t in p.values()),
                 sum(math.prod(SP._local(whole[k].shape, sp[k], mesh))
                     * whole[k].element_size() for k in whole),
                 len(split), sum(p[k].shape == whole[k].shape
                                 for k in split))
    sl = _slices(specs, swhole, mesh)
    save_tree(f"{task['result']}.{rank}.npz", {
        "out": np.stack([o.float().cpu().numpy() for o in outs]),
        "rows": np.array(rows.indices(B)[:2]),
        "state": {f: getattr(st, f).cpu().numpy() for f in st.spec},
        "slices": {f: sl[f"{i}.{f}"] for f in st.spec},
        "sent": np.array(sent, np.int64), "decode_sent": _sent(mesh),
        "params": held})


TASKS = {"step": task_step, "encode": task_encode, "save": task_save,
         "restore": task_restore, "psum": task_psum,
         "compress": task_compress, "serve": task_serve,
         "save_params": task_save_params, "recurrent": task_recurrent}


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
