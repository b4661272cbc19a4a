"""How far xlstm_350m's bf16 step-0 gradient lies from the exact one, in
one process and sharded: the port's `training.step._grads` on the train
CLI's seed-0 weights and batch (SyntheticLM seed 0), computed

  bf16        one process, every row at once (the config's dtype);
  bf16 2+2    one process, its rows 2 at a time (as a "data" rank);
  float32     one process, the same bf16 weights converted to float32;
  sharded     4 ranks over gloo at (data 2, model 2), bf16, each leaf's
              shards summed over the ranks that share it and gathered;
  sharded float32  the same ranks on the float32 weights;

then, for each pair, the global norms' relative difference and each
leaf's distance (L2 of the difference over the L2 of the second), the
largest few leaves and the embedding and head printed.

    python tools/xlstm_bf16_grads.py [--device cpu] [--layers 24]
        [--batch 4] [--seq 256]

Runs on the card unless ``--device cpu`` (then 4 CPU processes; at full
width and 24 layers ~2 minutes and ~8 GB). No JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _cfg(layers: int, dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("xlstm_350m"), n_layers=layers,
                               dtype=dtype)


def _batch(cfg, B: int, S: int, dev) -> dict:
    from repro_torch.data import DataConfig, SyntheticLM
    b = SyntheticLM(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                               seed=0)).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _named(tree, pre: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{pre}{i}.")
    else:
        yield pre[:-1], tree


def _numpy(grads) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in _named(grads)}


def one_process(args, dev) -> dict:
    """{"bf16", "bf16 2+2", "float32"}: each a {leaf: gradient}."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.models import transformer as T
    from repro_torch.training.step import _grads
    cfg, cfg32 = _cfg(args.layers, "bfloat16"), _cfg(args.layers, "float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    batch = _batch(cfg, args.batch, args.seq, dev)
    p32 = tree_map(lambda t: t.detach().float(), params)
    for t in leaves(params) + leaves(p32):
        t.requires_grad_(True)
    out = {"bf16": _numpy(_grads(params, batch, cfg)[0]),
           "float32": _numpy(_grads(p32, batch, cfg32)[0])}
    half = args.batch // 2
    parts = [_numpy(_grads(params, {k: v[i:i + half]
                                    for k, v in batch.items()}, cfg)[0])
             for i in (0, half)]
    out["bf16 2+2"] = {k: (parts[0][k] + parts[1][k]) / 2 for k in parts[0]}
    return out


def _rank(rank: int, world: int, tmp: str, args):
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.shard import Mesh, init_distributed, mesh_context
    from repro_torch.training.step import _grads, _sum_replicated
    torch.set_num_threads(1 if args.device == "cpu" else 2)
    dev = torch.device(args.device)
    init_distributed(dev, rank=rank, world=world,
                     init_method=f"file://{tmp}/rdzv", timeout_s=600)
    mesh = Mesh((2, 2), ("data", "model"), dev)
    cfg = _cfg(args.layers, "bfloat16")
    with mesh_context(mesh):
        specs = SP.train_specs(cfg, mesh)
    params = SP.init_shards(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, specs["params"], mesh)
    p32 = tree_map(lambda t: t.detach().float(), params)
    batch = _batch(cfg, args.batch, args.seq, dev)
    for name, c, p in (("sharded", cfg, params),
                       ("sharded float32", _cfg(args.layers, "float32"),
                        p32)):
        for _, t in _named(p):
            t.requires_grad_(True)
        with mesh_context(mesh):
            g, _ = _grads(p, batch, c, mesh, specs["params"])
            _sum_replicated(g, specs["params"], mesh)
        whole = SP.gather_tree({"p": g}, {"p": specs["params"]}, mesh)["p"]
        if rank == 0:
            np.savez(f"{tmp}/{name}.npz", **_numpy(whole))
        del g, whole
    torch.distributed.destroy_process_group()


def sharded(args) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [mp.get_context("spawn").Process(target=_rank,
                                                 args=(r, 4, tmp, args))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        if any(p.exitcode for p in procs):
            raise SystemExit(f"ranks exited {[p.exitcode for p in procs]}")
        out = {}
        for name in ("sharded", "sharded float32"):
            z = np.load(f"{tmp}/{name}.npz")
            out[name] = {k: z[k] for k in z.files}
        return out


def compare(a: dict, b: dict, tag: str) -> None:
    norm = lambda g: float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for v in g.values())))
    na, nb = norm(a), norm(b)
    print(f"{tag}: grad norm {na:.5f} against {nb:.5f} "
          f"(rel {abs(na - nb) / nb:.3e})")
    dist = {k: float(np.linalg.norm((a[k] - b[k]).ravel())
                     / max(np.linalg.norm(b[k].ravel()), 1e-30)) for k in b}
    top = sorted(dist, key=dist.get, reverse=True)[:4]
    for k in top + [k for k in ("embed", "lm_head") if k not in top]:
        print(f"    {k:32s} rel L2 {dist[k]:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (--device cpu runs on the CPU)")
    one = one_process(args, dev)
    sh = sharded(args)
    print(f"xlstm_350m, {args.layers} layers, {args.batch} x {args.seq}, "
          f"{args.device}:")
    compare(one["bf16 2+2"], one["bf16"], "bf16 2+2 vs bf16")
    compare(one["bf16"], one["float32"], "bf16 vs float32")
    compare(sh["sharded"], one["float32"], "sharded vs float32")
    compare(sh["sharded"], one["bf16"], "sharded vs bf16")
    compare(sh["sharded"], one["bf16 2+2"], "sharded vs bf16 2+2")
    compare(sh["sharded float32"], one["float32"],
            "sharded float32 vs float32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
