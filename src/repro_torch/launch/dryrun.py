"""Multi-pod dry run: trace every (arch × shape × mesh) cell on one rank
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_3b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.json

Per cell this shows, without a card:
  * the sharding holds together (the port's own step runs on the rank's
    shards: `launch.specs`' layouts, the mesh paths of `models/*`),
  * whether it fits (the shards' bytes and the step's peak above them,
    against the card's 80 GB),
  * and its roofline terms (`launch.roofline` over `launch.op_cost`'s
    counts: the card's published rates, `launch.mesh`).

Where the reference lowers and compiles each cell for 256 or 512 forced
host devices, the port runs one rank's step: a fake process group of the
mesh's world (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once, `parallel.shard.Mesh` counts its bytes) and
fake tensors (``FakeTensorMode``: shapes and dtypes, no data), so a
cell's step is the code a rank runs on the card, its kernels reporting
their work (`kernels.ops`). The fakes claim the card's device where this
torch is built with CUDA, else the CPU (the counts are the same).

The traced rank is the last one, the last coordinate on every axis: under
the port's splits the ranks' work differs only along the sequence and
slot splits over "model", where the last rank's causal share and slots
are the largest; rows split evenly over "data". A row's ``compile_s``
holds the trace's seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, get_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as RF

# full-attention archs skip long_500k (documented: DESIGN.md §5)
LONG_OK = {"mixtral_8x22b", "recurrentgemma_9b", "xlstm_350m"}

# per-arch microbatch counts for train_4k: global batch 256 (1M tokens)
# needs gradient accumulation to fit on the big archs (the reference's)
TRAIN_MICROBATCHES = {
    "mixtral_8x22b": 16, "qwen2_5_32b": 4, "codeqwen1_5_7b": 4,
    "qwen2_moe_a2_7b": 4, "recurrentgemma_9b": 4, "xlstm_350m": 4,
    "llama3_2_3b": 2, "internlm2_1_8b": 2, "qwen2_vl_2b": 2,
}

def skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "full attention is O(T^2)/O(T) HBM at 500K — sub-quadratic archs only"
    return None


def input_specs(cfg, shape_cfg, device="meta") -> dict:
    """Tensors of the shapes and dtypes of every model input of this cell
    (no data: on the meta device, or fake under a ``FakeTensorMode``)."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
    if shape_cfg.kind == "train":
        batch = {"tokens": empty((B, S), torch.int32),
                 "labels": empty((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = empty((B, cfg.encoder_seq, cfg.d_model),
                                    torch.float32)
        return batch
    if shape_cfg.kind == "prefill":
        batch = {"tokens": empty((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = empty((B, cfg.encoder_seq, cfg.d_model),
                                    torch.float32)
        return batch
    # decode: one new token against a cache of S
    return {"token": empty((B, 1), torch.int32), "pos": empty((B,),
                                                              torch.int32)}


def _round_up(n, b):
    return -(-n // b) * b


def fake_device() -> str:
    """The device the fakes claim: the card's where torch has CUDA."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


# -- the fake process group ---------------------------------------------------

_GROUP: dict = {}


def fake_mesh(sizes, axes, rank: int | None = None, device=None):
    """A `Mesh` of ``sizes`` over ``axes`` on a fake process group of its
    world, this process being ``rank`` (default the last); the group is
    started here, or restarted where it has another world or rank."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.parallel.shard import Mesh
    world = math.prod(sizes)
    rank = world - 1 if rank is None else rank
    device = device or fake_device()
    key = (tuple(sizes), tuple(axes), rank, device)
    if _GROUP.get("key") == key:
        return _GROUP["mesh"]
    close_fake_group()
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    _GROUP.update(key=key, mesh=Mesh(sizes, axes, device))
    return _GROUP["mesh"]


def close_fake_group():
    """End the fake process group `fake_mesh` started (if any)."""
    import torch.distributed as dist
    if _GROUP.pop("key", None) is not None:
        _GROUP.pop("mesh", None)
        dist.destroy_process_group()


# -- one rank's step on fake tensors ------------------------------------------

def _fake_params(cfg, specs, mesh, device):
    """Fake tensors of this rank's shards of every weight (``mesh`` None:
    the whole weights, one process)."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.launch import specs as SP
    whole = SP.param_shapes(cfg)
    shapes = [w.shape for w in leaves(whole)] if mesh is None else \
        SP.shard_shapes(cfg, specs, mesh)
    return unflatten(whole, [
        torch.empty(shape, dtype=w.dtype, device=device)
        for w, shape in zip(leaves(whole), shapes)])


def _rules(cfg):
    from repro_torch.parallel.shard import SSM_RULES
    # attention-free archs have no TP/CP use for "model": fold it into the
    # batch axis so every rank does useful work (the reference's rule)
    return SSM_RULES if cfg.family == "ssm" else None


def _cell_row(cost, chips: int, model_flops: float, args: int, t0: float,
              mesh) -> dict:
    rf = RF.analyze(cost, chips, model_flops)
    return {"status": "ok", "compile_s": round(time.time() - t0, 1),
            "bytes_per_device": int(args + cost.peak_bytes),
            "temp_bytes": int(cost.peak_bytes), "arg_bytes": int(args),
            "rank": 0 if mesh is None else mesh.rank,
            "rank_coords": {} if mesh is None else dict(mesh.coords),
            "coll_detail": rf.coll_detail,
            "coll_calls": dict(cost.coll_calls),
            "kernels": cost.kernels, "flops_f32": cost.flops_f32,
            "bytes_by_op": dict(list(cost.bytes_by_op.items())[:10]),
            **rf.row()}


def trace_train(cfg, mesh, B: int, S: int, microbatches: int = 1,
                device=None) -> dict:
    """One training step of ``cfg`` on this rank's shards
    (`launch.specs.train_specs`): the forward, the backward and the AdamW
    update on a global (B, S) batch, on fake tensors. Returns the cost
    row (`_cell_row`) with the weight and optimizer bytes apart."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs as SP
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.shard import mesh_context
    from repro_torch.training.step import init_opt_state, make_train_step
    device = device or fake_device()
    t0 = time.time()
    rules = _rules(cfg)
    with FakeTensorMode(), mesh_context(mesh, rules):
        specs = SP.train_specs(cfg, mesh)
        params = _fake_params(cfg, specs["params"], mesh, device)
        opt = init_opt_state(params, cfg)
        batch = _train_batch(cfg, B, S, device)
        args = op_cost.tree_bytes(params, opt, batch)
        held = (op_cost.tree_bytes(params), op_cost.tree_bytes(params, opt))
        step = make_train_step(cfg, AdamWConfig(),
                               microbatches=microbatches, specs=specs)
        _, cost = op_cost.measure(lambda: step(params, opt, batch), mesh)
        row = _cell_row(cost, mesh.size, RF.train_model_flops(cfg, B * S),
                        args, t0, mesh)
        row.update(weight_bytes=held[0], state_bytes=held[1])
    return row


def _train_batch(cfg, B, S, device):
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=S,
                                global_batch=B)
    return input_specs(cfg, shape, device)


def trace_serve(cfg, mesh, B: int, S: int, max_len: int, kinds=("prefill",
                "decode"), device=None) -> dict:
    """The serving steps of ``cfg`` on this rank's shards
    (`serving.engine.make_serve_fns` under the mesh: the contiguous
    cache; ``mesh`` None: one process on the whole weights): a prefill
    of a global (B, S) prompt into a fresh state, and one decode step
    against a cache of S tokens (each cache's length S, a cross cache's
    the encoder's). Returns {kind: cost row} for ``kinds``, each with
    the weight and state bytes apart."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs as SP
    from repro_torch.parallel.shard import mesh_context
    from repro_torch.serving.engine import make_serve_fns
    device = device or fake_device()
    rules = _rules(cfg)
    out = {}
    with FakeTensorMode():
        with mesh_context(mesh, rules) if mesh is not None else \
                contextlib.nullcontext():
            pspecs = None if mesh is None else SP.serve_param_specs(cfg,
                                                                    mesh)
            params = _fake_params(cfg, pspecs, mesh, device)
            init, prefill, decode = make_serve_fns(cfg, max_len=max_len,
                                                   device=device)
        for kind in kinds:
            t0 = time.time()
            state = init(B)
            shape = dataclasses.replace(get_shape(
                "prefill_32k" if kind == "prefill" else "decode_32k"),
                seq_len=S, global_batch=B)
            inp = input_specs(cfg, shape, device)
            if kind == "prefill":
                batch = inp if cfg.family == "encdec" else inp["tokens"]
                state_bytes = op_cost.tree_bytes(state)
                args = op_cost.tree_bytes(params, state, inp)
                with torch.no_grad():
                    _, cost = op_cost.measure(
                        lambda: prefill(params, batch, state), mesh)
                flops = RF.prefill_model_flops(cfg, B, S)
            else:
                _set_lengths(cfg, state, S)
                state_bytes = op_cost.tree_bytes(state)
                args = op_cost.tree_bytes(params, state, inp)
                with torch.no_grad():
                    _, cost = op_cost.measure(lambda: decode(
                        params, inp["token"], state, inp["pos"]), mesh)
                flops = RF.decode_model_flops(cfg, B, S)
            out[kind] = _cell_row(cost, 1 if mesh is None else mesh.size,
                                  flops, args, t0, mesh)
            out[kind].update(weight_bytes=op_cost.tree_bytes(params),
                             state_bytes=state_bytes)
            del state
    return out


def _set_lengths(cfg, state, S: int):
    """A fresh state as after a prompt of S tokens: each cache's length S
    (an encoder-decoder's cross caches the encoder's)."""
    from repro_torch.models.encdec import enc_cache_len
    layers = state["self"] if isinstance(state, dict) else state
    for c in layers:
        if hasattr(c, "length"):
            c.length = S
    if isinstance(state, dict):
        for c in state["cross"]:
            c.length = min(cfg.encoder_seq, enc_cache_len(cfg))


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """Trace one cell on the last rank of its mesh. Returns (the cost
    row, meta dict)."""
    cfg = get_config(arch)
    shape_cfg = get_shape(shape_name)
    sizes, axes = mesh_mod.production_shape(multi_pod)
    mesh = fake_mesh(sizes, axes)
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind == "train":
        row = trace_train(cfg, mesh, B, S, TRAIN_MICROBATCHES.get(arch, 1))
        model_flops = RF.train_model_flops(cfg, B * S)
    else:
        max_len = _round_up(S, cfg.quant.block_size)
        row = trace_serve(cfg, mesh, B, S, max_len,
                          kinds=(shape_cfg.kind,))[shape_cfg.kind]
        model_flops = row["model_flops"]
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": mesh.size, "model_flops": model_flops,
            "device": fake_device()}
    if shape_cfg.kind == "decode":
        # the reference's kernel-adjusted memory term: the int8 cache read
        # once and the bf16 weights, over the card's HBM rate
        kern_bytes = (cfg.kv_cache_bytes(B, min(S, max_len), 1) +
                      2 * RF.active_param_count(cfg)) / mesh.size
        meta["kernel_adjusted_memory_s"] = kern_bytes / mesh_mod.HBM_BW
    return row, meta


def run_cell(arch, shape_name, multi_pod, verbose=True):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    try:
        row, meta = lower_cell(arch, shape_name, multi_pod)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "failed", "error": f"{type(e).__name__}: {e}"}
    row = {**meta, **row}
    if verbose:
        print(f"[{meta['arch']} × {meta['shape']} × {meta['mesh']}] OK "
              f"trace={row['compile_s']}s "
              f"mem/dev={row['bytes_per_device']/2**30:.2f}GiB "
              f"(of {mesh_mod.HBM_BYTES / 2**30:.1f}) "
              f"compute={row['compute_s']*1e3:.1f}ms "
              f"memory={row['memory_s']*1e3:.1f}ms "
              f"coll={row['collective_s']*1e3:.1f}ms "
              f"bottleneck={row['bottleneck']} mfu={row['mfu']:.3f}")
        print(f"  rank {row['rank']} {row['rank_coords']}: args "
              f"{row['arg_bytes']} B, temps {row['temp_bytes']} B; kernels "
              f"{ {k: v['launches'] for k, v in row['kernels'].items()} }")
        print("  collectives:", row["coll_detail"])
        print("  bytes by op:", {k: f"{v / row['hbm_bytes']:.3f}" for k, v
                                 in list(row["bytes_by_op"].items())[:4]})
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    rows = []
    try:
        for mp in meshes:        # one fake group a mesh
            for arch in archs:
                for shape in shapes:
                    rows.append(run_cell(arch, shape, mp))
    finally:
        close_fake_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
