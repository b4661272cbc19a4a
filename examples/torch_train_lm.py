"""Training with the PyTorch port: a small dense model on synthetic data
with checkpoint/restart and INT8 gradient compression, through the port's
train launcher (`repro_torch.launch.train`).

The paper is an inference paper, so the main end-to-end driver is
examples/torch_serve_batched.py; this one runs the training substrate
(data -> step -> optimizer -> checkpoints -> restart supervisor).
``--hundred-m`` trains a ~100M-parameter config (12 layers, d_model 768,
GQA 12/4, vocab 32000) on internlm2's dense block. Checkpoints go to
``--ckpt-dir`` (default: a directory per config under the checkout's
git-ignored build/), so a rerun resumes.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --hundred-m --steps 300
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        # one directory per config: a 100M checkpoint must not meet a
        # smoke run's
        args.ckpt_dir = str(ROOT / "build" / (
            "ckpt_torch_llama100m" if args.hundred_m
            else "ckpt_torch_lm_smoke"))

    if args.hundred_m:
        import dataclasses

        import repro_torch.configs as C
        from repro_torch.configs import internlm2_1_8b, registry
        cfg100 = dataclasses.replace(
            internlm2_1_8b.config(), name="llama_100m", n_layers=12,
            d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
            head_dim=64)
        # ~ 12 * (768 * (768 + 2 * 256) + 768^2 + 3 * 768 * 2048)
        #   + 2 * 32000 * 768 ~ 105M
        base = registry.get_config
        C.get_config = (lambda name, smoke=False: cfg100
                        if name == "llama_100m" else base(name, smoke))
        arch_args = ["--arch", "llama_100m", "--batch", "4", "--seq", "256"]
    else:
        arch_args = ["--arch", "internlm2_1_8b", "--smoke",
                     "--batch", "8", "--seq", "128"]

    from repro_torch.launch import train as train_launcher
    return train_launcher.main(arch_args + [
        "--steps", str(args.steps),
        "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--grad-compression",
        "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
