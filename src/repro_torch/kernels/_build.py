"""Build the CUDA kernel sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, alone, into
``build/kernels/<name>-<hash>.so`` at the repository root; the hash covers
the sources, the shared headers and the flags, so an edited source builds
afresh and an unchanged one is reused. `build` starts one nvcc per missing
library, all at once, and returns each compiler log (``-Xptxas -v``:
registers, shared memory and spills per kernel). Nothing here runs at
import time: the CPU tests import every module and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode", "paged_prefill", "flat_decode", "quantize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}    # loaded libraries, one per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under CUDA_HOME)")
    return str(path)


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns {name: compiler
    log} for the builds that ran; raises with the log if one fails."""
    procs = {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, path)      # atomic: a cut build leaves no .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``fn`` of library ``name`` (built on first use), with
    its argument types declared and an int (cudaError_t) result."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
