"""The port's examples (examples/torch_*.py) run on the CPU at smoke size
with ``--device cpu``, each in a fresh interpreter where `jax` and the
reference package `repro` cannot be imported: each exits with 0 and
prints its key lines."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_RUN = r'''
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked: the port must not need it")
        return None

sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def _run(script: str, *args: str) -> str:
    res = subprocess.run(
        [sys.executable, "-c", _RUN, str(ROOT / "examples" / script),
         "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_quickstart():
    out = _run("torch_quickstart.py")
    for key in ("memory:", "max |err|:", "L2 err:", "attn err:",
                "fused decode attention out: (2, 4, 128) on cpu"):
        assert key in out, out
    err = float(out.split("max |err|:")[1].split()[0])
    assert err <= 1 / 254 + 1e-6          # paper Eq. 9 at absmax 1


def test_serve_batched():
    out = _run("torch_serve_batched.py")
    for key in ("10/10 requests served greedy", "10/10 served mixed "
                "sampled/greedy", "(finish=aborted), pool balanced: True",
                "10/10 served on the plan int8/int4",
                "greedy-token agreement", "sample continuation"):
        assert key in out, out


def test_train_lm(tmp_path):
    """Two steps with checkpoints, then a rerun to three that resumes."""
    out = _run("torch_train_lm.py", "--steps", "2", "--ckpt-dir",
               str(tmp_path))
    assert "step     0 loss" in out and "[train] done (0 restarts)" in out
    again = _run("torch_train_lm.py", "--steps", "3", "--ckpt-dir",
                 str(tmp_path))
    assert "[train] resumed from step 2" in again
