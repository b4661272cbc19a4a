"""Run the port's dry run (`repro_torch.launch.dryrun`) in a subprocess:
its fake process group lives and dies there, never in the pytest
worker. JAX-free."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_SERVE_RANKS = r'''
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
arch, gran, dtype, sizes, B, S, max_len = json.loads(sys.argv[1])
cfg = get_config(arch, smoke=True)
cfg = dataclasses.replace(cfg, dtype=dtype, quant=dataclasses.replace(
    cfg.quant, granularity=gran))
out = []
for r in range(sizes[0] * sizes[1]):
    mesh = DR.fake_mesh(tuple(sizes), ("data", "model"), rank=r)
    rows = DR.trace_serve(cfg, mesh, B, S, max_len)
    out.append({k: {f: v[f] for f in ("coll_detail", "weight_bytes",
                                      "state_bytes", "rank_coords")}
                for k, v in rows.items()})
DR.close_fake_group()
print(json.dumps(out))
'''


def run_json(code: str, *args, timeout: float = 300.0):
    """``code`` run in a fresh interpreter (``src`` on the path) with
    ``args``; its last stdout line parsed as JSON."""
    return run_json_many(code, [args], timeout)[0]


def run_json_many(code: str, argsets, timeout: float = 300.0) -> list:
    """`run_json` of ``code`` once for each of ``argsets``, the
    interpreters side by side."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in argsets]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            if p.returncode:
                raise AssertionError(f"subprocess failed:\n"
                                     f"{stderr[-4000:]}")
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def fake_serve_ranks(arch: str, gran: str, dtype: str, sizes, B: int,
                     S: int, max_len: int) -> list:
    """Every rank's fake trace of a smoke prefill and one decode step
    (`dryrun.trace_serve`): per rank {"prefill", "decode"} -> its bytes
    by collective, weight bytes, state bytes and coordinates."""
    return run_json(_SERVE_RANKS, json.dumps(
        [arch, gran, dtype, list(sizes), B, S, max_len]))
