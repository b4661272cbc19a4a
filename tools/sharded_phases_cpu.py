"""chip_smoke.py's sharded serving phase (`serve sharded`: internlm's
runs, the long-context stacks and whisper_small, and their training
runs; one process's references, 4 gloo ranks, the NCCL rank's runs,
then the tensor-parallel qwen2_5_32b run at (data 1, model 4); every
hold and prediction) rehearsed on the CPU at smoke size: the
torch.cuda timing and memory calls stubbed, every config its smoke one,
prompts of a few blocks past the smoke windows, 6 decode steps, the
kernels' launch checks off (the CPU runs the plain versions), the
(1, 1) rank's backend taken as NCCL; then the `dryrun` phase's traces
of those runs held against the ranks (bytes and roofline; no peaks). A
fault of the harness (a slice, a prediction, a hold) shows here in ~2
minutes, before a run on the card.

    python tools/sharded_phases_cpu.py
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

# the card's timing and memory calls: none on the CPU
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.max_memory_allocated = lambda *a, **k: 0
torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
torch.cuda.empty_cache = lambda *a, **k: None
torch.cuda.memory_allocated = lambda *a, **k: 0

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

# the train CLI's single-process references on the CPU
_cli = train_cli.main
train_cli.main = lambda argv, **kw: _cli(list(argv) + ["--device", "cpu"],
                                         **kw)


def cut(arch, layers, dtype=None):
    """Every model at its smoke size (the depth cuts ignored)."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, name=arch)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


C._cut = cut
# the ranks on the CPU, no kernel to count
C._rank_device = lambda rank: torch.device("cpu")
C._serve_launches = lambda cfg, run, *a: {}
C._n_attn = lambda cfg: 0
_run_path = C._run_path
C._run_path = lambda dev, label, needs, fn: _run_path(dev, label, (), fn)
# prompts past the smoke windows (16) and blocks (8), no block filled
C.SERVE_STEPS = 6
C.SERVE_SHARDED_RUNS = tuple(dict(r, S=24, max_len=32)
                             for r in C.SERVE_SHARDED_RUNS)
C.LONG_SERVE = tuple(dict(r, S=40 if r["arch"] != "xlstm_350m" else 32,
                          max_len=64) for r in C.LONG_SERVE)
C.TP_SERVE = tuple(dict(r, S=24, max_len=32, steps=6) for r in C.TP_SERVE)
C.LONG_TRAIN = tuple((lab, a, l, B, 32, st, ru, si, dt, h)
                     for lab, a, l, B, S, st, ru, si, dt, h in C.LONG_TRAIN)
C.SHARDED_TIMEOUT_S = 900
_orig_rank = C._serve_rank


def serve_rank_cpu(*a):
    """A spawned rank: it imports this module, so the stubs above hold
    in it too."""
    torch.set_num_threads(1)
    return _orig_rank(*a)


C._serve_rank = serve_rank_cpu
_orig_spawn = C._spawn_ranks


def spawn(world, *a, **kw):
    """`_spawn_ranks`; a lone rank's gloo group taken as the card's
    NCCL one."""
    reps = _orig_spawn(world, *a, **kw)
    if world == 1:
        for r in reps:
            r["backend"] = "nccl"
    return reps


C._spawn_ranks = spawn

if __name__ == "__main__":
    C.serve_sharded_full_width(torch.device("cpu"), "CPU")
    # the dry run against these ranks: bytes and roofline held, the peaks
    # printed (no device memory on the CPU); the training run is not made
    C.DRYRUN_TRAIN = ()
    C._peak_ratio = lambda label, who, peak, traced: float("nan")
    C.dryrun_phase("CPU")
    print("sharded phases: every hold passed on the CPU")
