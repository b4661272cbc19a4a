"""Where a cell's memory term comes from: the dry run's bytes by aten op
(`launch.op_cost.Cost.bytes_by_op`) for one config's training step or
serving steps on one fake rank, at several sequence lengths, so that a
term growing faster than the sequence shows which op makes it. CPU
only, no card.

    PYTHONPATH=src python tools/dryrun_by_op.py --arch xlstm_350m --smoke \\
        --kind train --batch 2 --seq 128 256
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--kind", choices=["train", "prefill", "decode"],
                    default="train")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = DR.fake_mesh((1, 1), ("data", "model"))
    try:
        for S in args.seq:
            if args.kind == "train":
                row = DR.trace_train(cfg, mesh, args.batch, S)
            else:
                row = DR.trace_serve(cfg, mesh, args.batch, S, 2 * S,
                                     kinds=(args.kind,))[args.kind]
            top = list(row["bytes_by_op"].items())[:args.top]
            print(f"S {S}: {row['hbm_bytes']:.0f} B in all; "
                  + ", ".join(f"{k} {v:.0f}" for k, v in top))
    finally:
        DR.close_fake_group()


if __name__ == "__main__":
    main()
