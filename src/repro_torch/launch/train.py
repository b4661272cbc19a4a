"""Training launcher of the port (port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --steps 3 --batch 4 --seq 2048

Trains any of the registry's architectures (an encoder-decoder on
`make_frames` frames made for each step, as the reference's launcher
does). Wires together the config registry, the data pipeline
(`SyntheticLM`, seed 0), the train step (optional microbatches and INT8
gradient compression), atomic checkpointing with restart-resume,
heartbeat and straggler monitoring, and the restart supervisor.

``--mesh host|pod|multipod`` trains sharded on the reference's meshes,
(1, 1), (16, 16) or (2, 16, 16), one process a rank: start them with
``torchrun --nproc-per-node N -m repro_torch.launch.train ...`` (rank,
world size and rendezvous come from its environment; the reference's
``--force-devices``, which fakes XLA host devices, has this for its
counterpart). The process group starts before the model: NCCL when each
rank has a card of its own, gloo otherwise (`parallel.shard`), and rank 0
prints which. Every rank draws the same seeded weights, keeping only its
shards of each part as it is made (`launch.specs.init_shards`: a rank
holds at most one layer, or the embedding, whole), takes its rows of
the same global batch, and only rank 0 prints and writes checkpoints.
Without ``--mesh`` it trains on one device. Runs on the card
by default (``--device cuda``) and fails without one; ``--device cpu``
runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def main(argv=None, on_step=None):
    """Parse ``argv`` and train. ``on_step(step, metrics, seconds)``, when
    given, is called after each step with the step's metrics as floats
    and its wall time (ending in a device synchronize)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true",
                    help="INT8 gradient compression with error feedback "
                         "(the paper's scheme on the gradients)")
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default=None,
                    help="train sharded on this mesh of ranks (torchrun)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, make_frames
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import encdec, transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.shard import init_distributed, mesh_context
    from repro_torch.runtime import (HeartbeatMonitor, RestartPolicy,
                                     run_with_restarts)
    from repro_torch.training.step import init_opt_state, make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = None
    device = torch.device(args.device)
    if args.mesh is not None:
        if device.type == "cuda" and device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", 0))
                % max(torch.cuda.device_count(), 1))
        device = transformer.check_device(device)
        backend = init_distributed(device)
        mesh = (make_host_mesh(device) if args.mesh == "host" else
                make_production_mesh(device,
                                     multi_pod=args.mesh == "multipod"))
        transformer.check_distributable(cfg, mesh)
    device = transformer.check_device(device)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"[train] mesh {mesh.shape} over {backend}"
            + (", collectives staged through host memory" if mesh.staged
               else ""))
    opt_cfg = AdamWConfig(lr=args.lr,
                          warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=0)
    data = SyntheticLM(dcfg)
    monitor = HeartbeatMonitor()
    specs = None if mesh is None else SP.train_specs(
        cfg, mesh, args.grad_compression)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              grad_compression=args.grad_compression,
                              specs=specs)
    ck_kw = {} if mesh is None else {"mesh": mesh, "specs": specs}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def make_loop():
        def loop():
            gen = torch.Generator(device=device).manual_seed(0)
            if mesh is not None:        # the same weights on every rank
                params = SP.init_shards(cfg, gen, device, specs["params"],
                                        mesh)
            else:
                init = (encdec.init_params if cfg.family == "encdec"
                        else transformer.init_params)
                params = init(cfg, gen, device=device)
            opt = init_opt_state(params, cfg,
                                 grad_compression=args.grad_compression)
            start = 0
            if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
                try:
                    ck = restore(args.ckpt_dir, s,
                                 {"params": params, "opt": opt}, **ck_kw)
                except ValueError as e:
                    # deterministic mismatch: don't let the restart
                    # supervisor burn its budget retrying it
                    raise SystemExit(
                        f"[train] checkpoint at {args.ckpt_dir} does not "
                        f"match --arch {args.arch}: {e}. Use a fresh "
                        f"--ckpt-dir.") from e
                params, opt = ck["params"], ck["opt"]
                start = s
                say(f"[train] resumed from step {s}")

            for i in range(start, args.steps):
                b = data.batch_at(i)
                if cfg.family == "encdec":
                    b["frames"] = make_frames(dcfg, cfg.d_model,
                                              cfg.encoder_seq, i)
                b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, b)
                sync()
                dt = time.perf_counter() - t0
                m = {k: float(v) for k, v in m.items()}
                if on_step is not None:
                    on_step(i, m, dt)
                rep = monitor.beat(i)
                if rep:
                    say(f"[straggler] step {rep.step}: "
                        f"{rep.step_time:.2f}s ({rep.factor:.1f}x median)")
                if i % args.log_every == 0 or i == args.steps - 1:
                    say(f"step {i:5d} loss {m['loss']:.4f} "
                        f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
                if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                    save(args.ckpt_dir, i + 1, {"params": params, "opt": opt},
                         **ck_kw)
            if args.ckpt_dir:
                save(args.ckpt_dir, args.steps,
                     {"params": params, "opt": opt}, **ck_kw)
        return loop

    with mesh_context(mesh) if mesh is not None else contextlib.nullcontext():
        restarts = run_with_restarts(make_loop,
                                     RestartPolicy(max_restarts=3))
    if monitor.stragglers:
        say(f"[train] {len(monitor.stragglers)} straggler steps flagged")
    say(f"[train] done ({restarts} restarts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
