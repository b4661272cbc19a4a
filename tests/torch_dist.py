"""Start the ranks of a distributed test (JAX-free): one process a rank
running tests/torch_dist_worker.py over a gloo group with a ``file://``
rendezvous in the test's temporary directory; each rank single-threaded.
A rank that fails, or a run past its time limit, fails the test with
the ranks' stderr."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_dist_worker.py"
SRC = HERE.parent / "src"


def run_ranks(tmp_path, world: int, tasks: list, timeout: float = 300.0,
              name: str = "job", device: str = "cpu") -> None:
    tmp_path = Path(tmp_path)
    job = tmp_path / f"{name}.json"
    rdzv = tmp_path / f"{name}.rdzv"
    job.write_text(json.dumps({"rendezvous": f"file://{rdzv}",
                               "device": device,
                               "timeout_s": min(timeout, 120),
                               "tasks": tasks}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(tmp_path / f"{name}.{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(job), str(r),
                               str(world)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                    + f.read()[-4000:])
        f.close()
    if any(p.returncode for p in procs):
        raise AssertionError("ranks failed:\n" + "\n".join(text))


def step_task(arch, mesh, axes, weights, batch, result, opt, **kw) -> dict:
    return {"kind": "step", "arch": arch, "mesh": list(mesh),
            "axes": list(axes), "weights": str(weights),
            "batch": str(batch), "result": str(result), "opt": opt, **kw}
