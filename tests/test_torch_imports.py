"""The port stands alone: every module of `repro_torch` (the training
path's too: `training`, `optim`, `data`, `checkpoint`, `runtime`,
`launch.train`, `kernels.flash_fwd`) imports in a fresh interpreter where
`jax` and the reference package `repro` cannot be imported (the dry run,
its roofline and cost model too), `chip_smoke.py`
and `chip_ab.py` import neither, and `chip_smoke.py` copied alone into an
empty directory fails without printing a result."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCKER = r'''
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked: the port must not need it")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    __import__(n)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(" ".join(names))
'''


def test_every_port_module_imports_without_jax_or_the_reference():
    res = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 48
    assert {"repro_torch.training.step", "repro_torch.training.loss",
            "repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.runtime.fault", "repro_torch.launch.train",
            "repro_torch.kernels.flash_fwd", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.launch.op_cost",
            "repro_torch.launch.mesh", "repro_torch.core.costing"} <= names


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    src = (ROOT / "chip_smoke.py").read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_torch)"
                     r".*$", src, flags=re.M)
    assert not bad, bad


def test_chip_ab_imports_neither_jax_nor_the_reference():
    src = (ROOT / "chip_ab.py").read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_torch)"
                     r".*$", src, flags=re.M)
    assert not bad, bad


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_distributed_workers_import_neither_jax_nor_the_reference():
    """The rank processes of the distributed tests (and the card's `gpu`
    file) start from JAX-free modules: tests/torch_dist_worker.py and
    tests/torch_dist.py import with jax and repro blocked."""
    code = _BLOCKER.split("import repro_torch")[0] + (
        "import torch_dist, torch_dist_worker\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro') "
        "for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert res.returncode == 0, res.stderr
