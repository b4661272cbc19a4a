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
recurrent stacks (`models.recurrent_mesh`): recurrentgemma_9b (RG-LRU
channel parallel, local attention context parallel in between) and
xlstm_350m (mLSTM head parallel, sLSTM whole on each rank of a row
block) at (2, 2), (2, 1, 2) and (1, 4), and both under `SSM_RULES`
("ssm": the batch over every axis, every rank whole sequences of its own
rows, the vocab-parallel embedding and head then whole) at (2, 2); the
encoder-decoder whisper_small (`models.encdec`: its encoder context
parallel over its 24 smoke frames, cross-attention over the encoder K/V
gathered along the encoder sequence, the tied vocab-parallel head) at
(2, 2), (2, 1, 2) and (1, 4), batch 4 x 32 with its `make_frames`
frames; each rank's `encode` output (its rows and positions) against
the reference's encoder at (2, 2) and (1, 4); internlm2_1_8b's and whisper_small's checkpoints (with
--grad-compression's error state) saved at (2, 2) restored at (1, 1)
and at (2, 1, 2), bit for bit; the train CLI on the one-rank host mesh
for both."""
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
         ("internlm2_1_8b", "plain", 3, 31, ("2x2",)),
         ("recurrentgemma_9b", "plain", 4, 32, ("2x2", "pod", "1x4")),
         ("recurrentgemma_9b", "ssm", 4, 32, ("2x2",)),
         ("xlstm_350m", "plain", 4, 32, ("2x2", "pod", "1x4")),
         ("xlstm_350m", "ssm", 4, 32, ("2x2",)),
         ("whisper_small", "plain", 4, 32, ("2x2", "pod", "1x4"))]
ODD = {"1x4": ((1, 4), ("data", "model"))}
# the checkpoints saved at (2, 2) and restored elsewhere
SAVED = ("internlm2_1_8b", "whisper_small")
ENCODE_MESHES = ("2x2", "1x4")
SRC = Path(__file__).resolve().parents[1] / "src"


def pp_cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _kw(mode):
    return {"gc": mode == "gc", "mb": 2 if mode == "mb" else 1}


def _rules(mode):
    return {"rules": "ssm"} if mode == "ssm" else {}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's reference and single-process step in this process,
    then the ranks: every sharded step, the sharded encoders and the
    checkpoint saves in one 4-rank job, the restores at (1, 1) in a
    1-rank job and at (2, 1, 2) in another 4-rank one."""
    d = tmp_path_factory.mktemp("dist")
    out, tasks = {}, []
    for arch, mode, B, S, meshes in CASES:
        mods = TP.models(arch)
        b = TP.batch(mods[0][0], B, S)
        key = f"{arch}-{mode}-{B}x{S}"
        save_tree(d / f"{key}.w.npz", jax.tree.map(np.asarray, mods[0][1]))
        save_tree(d / f"{key}.b.npz", b)
        plain = f"{arch}-plain-{B}x{S}"       # the rules move no value
        out[key] = out[plain] if mode == "ssm" else \
            TP.step_both(mods, b, **_kw(mode))
        for m in meshes + (("1x4",) if key == "internlm2_1_8b-plain-4x32"
                           else ()):
            sizes, axes = {**MESHES, **ODD}[m]
            tasks.append(step_task(arch, sizes, axes, d / f"{key}.w.npz",
                                   d / f"{key}.b.npz", d / f"{key}.{m}.npz",
                                   TP.OPT, **_kw(mode), **_rules(mode)))
    wk = "whisper_small-plain-4x32"
    out["encode"] = TP.encode_reference(d / f"{wk}.w.npz",
                                        d / f"{wk}.b.npz")
    for m in ENCODE_MESHES:
        sizes, axes = {**MESHES, **ODD}[m]
        tasks.append(step_task("whisper_small", sizes, axes,
                               d / f"{wk}.w.npz", d / f"{wk}.b.npz",
                               d / f"encode.{m}", TP.OPT, kind="encode"))
    saves = [dict(step_task(arch, (2, 2), ("data", "model"),
                            d / f"{arch}-plain-4x32.w.npz",
                            d / f"{arch}-plain-4x32.b.npz",
                            d / f"saved.{arch}.npz", TP.OPT, gc=True),
                  kind="save", ckpt=str(d / f"ckpt.{arch}"))
             for arch in SAVED]
    run_ranks(d, 4, tasks + saves, name="steps")
    restore = [dict(save, kind="restore", mesh=sizes, axes=axes,
                    result=str(d / f"restored.{save['arch']}.{n}.npz"))
               for n, (sizes, axes) in (("1x1", ((1, 1), ("data", "model"))),
                                        ("pod", MESHES["pod"]))
               for save in saves]
    run_ranks(d, 1, restore[:len(saves)], name="restore1")
    run_ranks(d, 4, restore[len(saves):], name="restore4")
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
    if mode == "ssm":       # the rows over every axis, whole sequences
        assert str(got["layout"]["batch"]) == "data+model", got["layout"]
        assert str(got["layout"]["seq"]) == "", got["layout"]


@pytest.mark.parametrize("mesh", ENCODE_MESHES)
def test_sharded_encoder_matches_reference(results, mesh):
    """Each rank's block of the encoder output (its rows and positions)
    against the reference's jitted `encode` (no remat), within 1e-5."""
    d, out = results
    want = out["encode"]
    for r in range(4):
        got = load_tree(d / f"encode.{mesh}.{r}.npz")
        rows, cols = slice(*got["rows"]), slice(*got["positions"])
        assert got["out"].shape == want[rows, cols].shape, got["out"].shape
        np.testing.assert_allclose(got["out"], want[rows, cols],
                                   rtol=TP.RTOL, atol=TP.RTOL,
                                   err_msg=f"{mesh} rank {r}")
    if mesh == "1x4":               # the 24 frames over the 4 "model" ranks
        assert {tuple(load_tree(d / f"encode.{mesh}.{r}.npz")["positions"])
                for r in range(4)} == {(6 * i, 6 * i + 6) for i in range(4)}


@pytest.mark.parametrize("arch", SAVED)
@pytest.mark.parametrize("mesh", ["1x1", "pod"])
def test_checkpoint_saved_at_2x2_restores_elsewhere(results, mesh, arch):
    d, _ = results
    saved, got = load_tree(d / f"saved.{arch}.npz"), load_tree(
        d / f"restored.{arch}.{mesh}.npz")
    assert int(got.pop("step")) == 1
    for (path, a, b) in TP.pairs(got, saved):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "whisper_small"])
def test_train_cli_on_the_host_mesh(tmp_path, capsys, arch):
    """The train CLI with ``--mesh host`` (one rank: what ``torchrun
    --nproc-per-node 1`` starts) prints the one-device run's losses and
    grad norms (bf16: within 1e-3, the vocab-parallel loss sums in
    another order), saves through the mesh and resumes from its
    checkpoint; whisper_small on its `make_frames` frames."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
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
