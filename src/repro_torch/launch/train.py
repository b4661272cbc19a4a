"""Training launcher of the port (port of ``repro.launch.train`` on one
card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --steps 3 --batch 4 --seq 2048

Wires together the config registry, the data pipeline (`SyntheticLM`,
seed 0), the train step (optional microbatches and INT8 gradient
compression), atomic checkpointing with restart-resume, heartbeat and
straggler monitoring, and the restart supervisor. The reference's
``--mesh`` and ``--force-devices`` have no counterpart: the port runs on
one device. Runs on the card by default (``--device cuda``) and fails
without one; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (HeartbeatMonitor, RestartPolicy,
                                     run_with_restarts)
    from repro_torch.training.step import init_opt_state, make_train_step

    device = transformer.check_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    transformer.check_trainable(cfg)
    opt_cfg = AdamWConfig(lr=args.lr,
                          warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=0)
    data = SyntheticLM(dcfg)
    monitor = HeartbeatMonitor()
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              grad_compression=args.grad_compression)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def make_loop():
        def loop():
            params = transformer.init_params(
                cfg, torch.Generator(device=device).manual_seed(0),
                device=device)
            opt = init_opt_state(params,
                                 grad_compression=args.grad_compression)
            start = 0
            if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
                try:
                    ck = restore(args.ckpt_dir, s,
                                 {"params": params, "opt": opt})
                except ValueError as e:
                    # deterministic mismatch: don't let the restart
                    # supervisor burn its budget retrying it
                    raise SystemExit(
                        f"[train] checkpoint at {args.ckpt_dir} does not "
                        f"match --arch {args.arch}: {e}. Use a fresh "
                        f"--ckpt-dir.") from e
                params, opt = ck["params"], ck["opt"]
                start = s
                print(f"[train] resumed from step {s}")

            for i in range(start, args.steps):
                b = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(i).items()}
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, b)
                sync()
                dt = time.perf_counter() - t0
                m = {k: float(v) for k, v in m.items()}
                if on_step is not None:
                    on_step(i, m, dt)
                rep = monitor.beat(i)
                if rep:
                    print(f"[straggler] step {rep.step}: "
                          f"{rep.step_time:.2f}s ({rep.factor:.1f}x median)")
                if i % args.log_every == 0 or i == args.steps - 1:
                    print(f"step {i:5d} loss {m['loss']:.4f} "
                          f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
                if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                    save(args.ckpt_dir, i + 1, {"params": params, "opt": opt})
            if args.ckpt_dir:
                save(args.ckpt_dir, args.steps,
                     {"params": params, "opt": opt})
        return loop

    restarts = run_with_restarts(make_loop, RestartPolicy(max_restarts=3))
    if monitor.stragglers:
        print(f"[train] {len(monitor.stragglers)} straggler steps flagged")
    print(f"[train] done ({restarts} restarts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
