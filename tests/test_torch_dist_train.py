"""The port's sharded training step on 4 gloo ranks on the CPU (each a
process of the JAX-free tests/torch_dist_worker.py) against the
reference's jitted UNSHARDED step and the port's single-process step, on
the same numpy weights and batch (smoke configs in float32, QKV biases
seeded non-zero; helpers in tests/torch_train_parity.py):
internlm2_1_8b (plain, --grad-compression, 2 microbatches), qwen2_5_32b
(QKV bias) and qwen2_vl_2b (M-RoPE, bias) on meshes (data 2, model 2)
and (pod 2, data 1, model 2), batch 4 x 32 (the sequence and the vocab
split over "model", the rows over the FSDP axes). Tolerance: loss, aux
and grad norm within 1e-5 relative, and every parameter, m, v and
master weight leaf by leaf within 1e-5 of |b| + max |b| (the rule of
tests/test_torch_train.py; a correct sharding moves float32 sums by
ulps, where the reference's bf16 sharded step moves bf16 leaves by up
to 1.1% in L2); with compression at most 1e-4 of the elements a level
apart, and the error state held as there. Also: a sequence and batch
that do not divide the mesh (B 3, S 31: both replicate, as
`logical_spec` says) and kv_heads 2 < model 4 on a (1, 4) mesh; the
refusal of the recurrent and encoder-decoder configs under a mesh (a
ValueError citing ROADMAP item 15); and a checkpoint saved at (2, 2)
restored at (1, 1) and at (2, 1, 2), bit for bit; the train CLI on the
one-rank host mesh."""
import json
import os
import subprocess
import sys
from pathlib import Path

import dataclasses

import jax
import numpy as np
import pytest

import torch_train_parity as TP
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_config
from torch_dist import run_ranks, step_task
from torch_dist_worker import load_tree, save_tree

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model"))}
# (arch, mode, B, S, meshes)
CASES = [("internlm2_1_8b", "plain", 4, 32, ("2x2", "pod")),
         ("internlm2_1_8b", "gc", 4, 32, ("2x2", "pod")),
         ("internlm2_1_8b", "mb", 4, 32, ("2x2", "pod")),
         ("qwen2_5_32b", "plain", 4, 32, ("2x2", "pod")),
         ("qwen2_vl_2b", "plain", 4, 32, ("2x2", "pod")),
         ("internlm2_1_8b", "plain", 3, 31, ("2x2",))]
ODD = {"1x4": ((1, 4), ("data", "model"))}
REFUSED = ("recurrentgemma_9b", "xlstm_350m", "whisper_small")
SRC = Path(__file__).resolve().parents[1] / "src"


def pp_cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _kw(mode):
    return {"gc": mode == "gc", "mb": 2 if mode == "mb" else 1}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's reference and single-process step in this process,
    then the ranks: every sharded step, the refusals and the checkpoint
    save in one 4-rank job, the restores at (1, 1) in a 1-rank job and at
    (2, 1, 2) in another 4-rank one."""
    d = tmp_path_factory.mktemp("dist")
    out, tasks = {}, []
    for arch, mode, B, S, meshes in CASES:
        mods = TP.models(arch)
        b = TP.batch(mods[0][0], B, S)
        key = f"{arch}-{mode}-{B}x{S}"
        save_tree(d / f"{key}.w.npz", jax.tree.map(np.asarray, mods[0][1]))
        save_tree(d / f"{key}.b.npz", b)
        out[key] = TP.step_both(mods, b, **_kw(mode))
        for m in meshes + (("1x4",) if key == "internlm2_1_8b-plain-4x32"
                           else ()):
            sizes, axes = {**MESHES, **ODD}[m]
            tasks.append(step_task(arch, sizes, axes, d / f"{key}.w.npz",
                                   d / f"{key}.b.npz", d / f"{key}.{m}.npz",
                                   TP.OPT, **_kw(mode)))
    ck = "internlm2_1_8b-plain-4x32"
    tasks.append({"kind": "refuse", "mesh": [2, 2], "axes": ["data", "model"],
                  "archs": list(REFUSED), "batch": str(d / f"{ck}.b.npz"),
                  "result": str(d / "refuse.json")})
    save = dict(step_task("internlm2_1_8b", (2, 2), ("data", "model"),
                          d / f"{ck}.w.npz", d / f"{ck}.b.npz",
                          d / "saved.npz", TP.OPT, gc=True),
                kind="save", ckpt=str(d / "ckpt"))
    tasks.append(save)
    run_ranks(d, 4, tasks, name="steps")
    restore = [dict(save, kind="restore", mesh=sizes, axes=axes,
                    result=str(d / f"restored.{n}.npz"))
               for n, (sizes, axes) in (("1x1", ((1, 1), ("data", "model"))),
                                        ("pod", MESHES["pod"]))]
    run_ranks(d, 1, restore[:1], name="restore1")
    run_ranks(d, 4, restore[1:], name="restore4")
    return d, out


@pytest.mark.parametrize("arch,mode,B,S,mesh", [
    (a, m, B, S, x) for a, m, B, S, meshes in CASES for x in meshes] + [
    ("internlm2_1_8b", "plain", 4, 32, "1x4")])
def test_sharded_step_matches_reference_and_one_process(results, arch, mode,
                                                        B, S, mesh):
    d, out = results
    key = f"{arch}-{mode}-{B}x{S}"
    got = load_tree(d / f"{key}.{mesh}.npz")
    (rp, ro, rm), (pp, po, pm) = out[key]
    gc = mode == "gc"
    flips = 1e-4 if gc else 0.0
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        for want in (rm[k], pm[k]):
            np.testing.assert_allclose(float(got["metrics"][k]), float(want),
                                       rtol=TP.RTOL,
                                       atol=1e-7 if k == "aux_loss" else 0,
                                       err_msg=k)
    TP.close_trees(got["params"], jax.tree.map(np.asarray, rp), TP.RTOL,
                   flips=flips)
    TP.close_trees(got["params"], bridge.tree_to_numpy(pp, pp_cfg(arch)),
                   TP.RTOL, flips=flips)
    ra = jax.tree.map(np.asarray, ro["adam"])
    for k in ("m", "v", "master"):
        TP.close_trees(got[k], ra[k], TP.RTOL, flips=flips)
    if gc:
        TP.check_grad_err(got["grad_err"], ro, rm, TP.RTOL, flips)
    # the wire: bytes went over every axis of the mesh
    axes = {k.split(":")[1] for k in got["stats"]}
    assert any("model" in a for a in axes), axes


def test_refuses_recurrent_and_encdec_under_a_mesh(results):
    d, _ = results
    msgs = json.loads((d / "refuse.json").read_text())
    for arch in REFUSED:
        assert msgs[arch].startswith("ValueError"), (arch, msgs[arch])
        assert "ROADMAP item 15" in msgs[arch], msgs[arch]


@pytest.mark.parametrize("mesh", ["1x1", "pod"])
def test_checkpoint_saved_at_2x2_restores_elsewhere(results, mesh):
    d, _ = results
    saved, got = load_tree(d / "saved.npz"), load_tree(
        d / f"restored.{mesh}.npz")
    assert int(got.pop("step")) == 1
    for (path, a, b) in TP.pairs(got, saved):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_train_cli_on_the_host_mesh(tmp_path, capsys):
    """The train CLI with ``--mesh host`` (one rank: what ``torchrun
    --nproc-per-node 1`` starts) prints the one-device run's losses and
    grad norms (bf16: within 1e-3, the vocab-parallel loss sums in
    another order), saves through the mesh and resumes from its
    checkpoint."""
    from repro_torch.launch import train
    argv = ["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--log-every", "1"]
    train.main(argv + ["--steps", "2"])
    plain = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    run = lambda steps: subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--steps", str(steps), "--mesh", "host", "--ckpt-dir",
         str(tmp_path / "ck")], env=env, capture_output=True, text=True,
        timeout=300)
    first = run(2)
    assert first.returncode == 0, first.stderr[-3000:]
    mesh = [ln for ln in first.stdout.splitlines() if ln.startswith("step")]
    assert len(mesh) == len(plain) == 2
    for a, b in zip(mesh, plain):        # "step i loss x gnorm y lr z"
        a, b = a.split(), b.split()
        assert a[:2] == b[:2] and a[-1] == b[-1], (a, b)
        np.testing.assert_allclose([float(a[3]), float(a[5])],
                                   [float(b[3]), float(b[5])], rtol=1e-3)
    again = run(3)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "[train] resumed from step 2" in again.stdout
