"""The port stands alone: every module of `repro_torch` imports in a fresh
interpreter where `jax` and the reference package `repro` cannot be
imported, `chip_smoke.py` imports neither, and `chip_smoke.py` copied
alone into an empty directory fails without printing a result."""
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
print(len(names))
'''


def test_every_port_module_imports_without_jax_or_the_reference():
    res = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 25


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    src = (ROOT / "chip_smoke.py").read_text()
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
