"""The training path of the port against the reference, on the CPU:
internlm2_1_8b smoke in float32 with bridged weights (`checkpoint.bridge`),
inputs from numpy.

- `SyntheticLM` and `MemmapDataset` batches bitwise; `cosine_schedule` and
  `next_token_loss` within 1e-6 relative.
- `forward_train` logits within 1e-4 (with and without remat).
- One `make_train_step` step against the jitted reference step: the
  step counter, loss, grad_norm and lr within 1e-5 relative; every
  parameter, m, v and master weight within 1e-5 (|b| + max |b| of its
  leaf) (gradient elements that nearly cancel carry float32 rounding at
  the leaf's scale, not their own); also with ``microbatches=2``. Adam's
  eps is 1e-4 here, not 1e-8: the first step's update m / (sqrt(v) + eps)
  is sign(g) wherever |g| >> eps, and a gradient element near eps would
  turn its float32 rounding into a step of up to lr.
  With ``grad_compression=True`` (the stacked per-channel quantization)
  a gradient a float32 rounding away from a half step of its channel may
  quantize one level apart in the two frameworks: at most 1e-4 of the
  elements may differ by more, and the error state (the residual, at
  most half a level, 1/254 of the channel's absmax) is held to 1e-5 of
  254 times its leaf's largest value.
  In bfloat16 the step holds the reference's loss and grad_norm within
  1e-2 relative: gradients are bf16 and the two frameworks round them at
  other points.
- `compress_with_feedback` on identical numpy gradients, in the
  reference's stacked layout: the compressed gradients bitwise against
  the jitted reference; the new error state bitwise equal to
  (g + e) - compressed, its definition. The jitted reference's own error
  state is not: XLA contracts its g32 - q * s into a fused
  multiply-subtract, so it sits within one rounding of q * s
  (2^-24 |q * s|) of that (ROADMAP queue 3). The reference's
  ``Q.quantize`` divides by an unclamped scale, the port's quantize
  kernel by max(s, 1e-30) (queue 3 too): they differ only for a channel
  whose absmax lies below 127e-30, which no gradient here has.
- Checkpoints (save / restore / keep / latest_step), the restart
  supervisor, and the train CLI on the CPU ending at step 3 and resuming.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.data import pipeline as RD
from repro.models import transformer as RT
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro.training import loss as RL
from repro.training import step as RS
from repro_torch.checkpoint import bridge, latest_step, restore, save
from repro_torch.checkpoint import valid_steps
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.data import DataConfig, MemmapDataset, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, compression, cosine_schedule
from repro_torch.runtime import (HeartbeatMonitor, RestartPolicy,
                                 run_with_restarts)
from repro_torch.training import loss as L
from repro_torch.training import step as S
from torch_parity import to_torch
from torch_train_parity import close_trees as _close_trees
from torch_train_parity import pairs as _pairs

jax.config.update("jax_platform_name", "cpu")

B, SEQ = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)


def _models(dtype="float32"):
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype=dtype)
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype=dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                       pcfg, "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def _batch(vocab, seed=3):
    return RD.SyntheticLM(RD.DataConfig(seq_len=SEQ, global_batch=B,
                                        vocab=vocab, seed=seed)).batch_at(0)


# -- data, schedule, loss -----------------------------------------------------

def test_synthetic_and_memmap_batches_are_bitwise(tmp_path):
    kw = dict(seq_len=SEQ, global_batch=B, vocab=300, seed=7)
    for step in (0, 5):
        ref = RD.SyntheticLM(RD.DataConfig(**kw)).batch_at(step)
        port = SyntheticLM(DataConfig(**kw)).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(port[k], ref[k])
    path = tmp_path / "tokens.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    ref = RD.MemmapDataset(str(path), RD.DataConfig(**kw)).batch_at(3)
    port = MemmapDataset(str(path), DataConfig(**kw)).batch_at(3)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(port[k], ref[k])


def test_cosine_schedule_matches_reference():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    steps = np.asarray([0, 1, 5, 10, 11, 50, 99, 100, 150], np.int32)
    ref = jax.jit(RA.cosine_schedule(RefAdamWConfig(**kw)))(
        jnp.asarray(steps))
    port = cosine_schedule(AdamWConfig(**kw))(torch.from_numpy(steps))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


def test_next_token_loss_matches_reference():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 7, 384).astype(np.float32) * 3
    labels = rng.randint(0, 300, (3, 7)).astype(np.int32)
    labels[0, :3] = -1                               # masked positions
    ref = RL.next_token_loss(jnp.asarray(logits), jnp.asarray(labels), 300)
    port = L.next_token_loss(to_torch(logits), to_torch(labels), 300)
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-6)
    all_masked = L.next_token_loss(to_torch(logits),
                                   torch.full((3, 7), -1), 300)
    assert float(all_masked) == 0.0


# -- model and train step -----------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_logits_match_reference(remat):
    (rcfg, rparams), (pcfg, pparams) = _models()
    tok = _batch(rcfg.vocab)["tokens"]
    ref, _ = RT.forward_train(rparams, jnp.asarray(tok), rcfg, remat=remat)
    port, aux = T.forward_train(pparams, to_torch(tok), pcfg, remat=remat)
    assert float(aux) == 0.0
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def _step_both(mb, gc, dtype="float32"):
    (rcfg, rparams), (pcfg, pparams) = _models(dtype)
    batch = _batch(rcfg.vocab)
    ropt = RS.init_opt_state(rparams, grad_compression=gc)
    rstep = jax.jit(RS.make_train_step(rcfg, RefAdamWConfig(**OPT),
                                       microbatches=mb, grad_compression=gc))
    rp, ro, rm = rstep(rparams, ropt, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    popt = S.init_opt_state(pparams, pcfg, grad_compression=gc)
    pstep = S.make_train_step(pcfg, AdamWConfig(**OPT), microbatches=mb,
                              grad_compression=gc)
    pp, po, pm = pstep(pparams, popt, {k: to_torch(v)
                                       for k, v in batch.items()})
    return (rp, ro, rm), (pp, po, pm)


@pytest.mark.parametrize("mb,gc", [(1, False), (2, False), (1, True)],
                         ids=["plain", "microbatches2", "compressed"])
def test_train_step_matches_jitted_reference(mb, gc):
    (rp, ro, rm), (pp, po, pm) = _step_both(mb, gc)
    rtol, flips = 1e-5, (1e-4 if gc else 0.0)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=rtol)
    _close_trees(bridge.tree_to_numpy(pp), jax.tree.map(np.asarray, rp),
                 rtol, flips=flips)
    ra = jax.tree.map(np.asarray, ro["adam"])
    assert int(po["adam"]["step"]) == int(ra["step"]) == 1
    for k in ("m", "v", "master"):
        _close_trees(bridge.tree_to_numpy(po["adam"][k]), ra[k], rtol,
                     flips=flips)
    assert ("grad_err" in po) == gc
    if gc:
        _close_trees(bridge.tree_to_numpy(po["grad_err"]),
                     jax.tree.map(np.asarray, ro["grad_err"]), rtol,
                     scale=254.0, flips=flips)


def test_train_step_in_bfloat16_tracks_reference():
    (rp, ro, rm), (pp, po, pm) = _step_both(1, False, "bfloat16")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-2)
    assert pp["embed"].dtype == torch.bfloat16


def test_opt_state_bridge_round_trips_the_reference_state():
    (rcfg, rparams), (pcfg, pparams) = _models()
    ropt = jax.tree.map(np.asarray, RS.init_opt_state(
        rparams, grad_compression=True))
    popt = bridge.opt_state_from_numpy(ropt, pcfg, "cpu")
    own = S.init_opt_state(pparams, pcfg, grad_compression=True)
    for k in ("m", "v", "master"):
        for t in (popt, own):
            for path, a, b in _pairs(bridge.tree_to_numpy(t["adam"][k]),
                                     ropt["adam"][k]):
                np.testing.assert_array_equal(a, b, err_msg=path)
    for path, a, b in _pairs(bridge.tree_to_numpy(popt["grad_err"]),
                             ropt["grad_err"]):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert int(popt["adam"]["step"]) == 0


def test_compress_with_feedback_is_bitwise_in_the_stacked_layout():
    (rcfg, rparams), (pcfg, pparams) = _models()
    rng = np.random.RandomState(11)
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** rng.randint(-6, 1)
                   ).astype(np.float32), rparams)
    err = jax.tree.map(lambda g: (rng.randn(*g.shape) * 1e-3).astype(
        np.float32), grads)
    rcomp, rerr = jax.jit(RC.compress_with_feedback)(grads, err)
    pgrads = bridge.params_from_numpy(grads, pcfg, "cpu")
    perr = bridge.opt_state_from_numpy(
        {"adam": {"m": grads, "v": grads, "master": grads, "step": 0},
         "grad_err": err}, pcfg, "cpu")["grad_err"]
    pcomp, pnew = compression.compress_with_feedback(pgrads, perr, pcfg)
    rcomp, rerr = (jax.tree.map(np.asarray, t) for t in (rcomp, rerr))
    residual = jax.tree.map(lambda g, e, c: (g + e) - c, grads, err, rcomp)
    for (path, a, b), (_, e, r), (_, _, c) in zip(
            _pairs(bridge.tree_to_numpy(pcomp), rcomp),
            _pairs(bridge.tree_to_numpy(pnew), residual),
            _pairs(rerr, rerr)):
        np.testing.assert_array_equal(a, b, err_msg=path)
        np.testing.assert_array_equal(e, r, err_msg=path)
        assert (np.abs(e - c) <= 2.0 ** -24 * np.abs(b)).all(), path


# -- checkpoints, restarts, the CLI ------------------------------------------

def test_checkpoint_save_restore_keep_latest(tmp_path):
    d = str(tmp_path)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3).bfloat16(),
                       "layers": [{"s": torch.ones(3)}]},
            "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    for step in (1, 2, 3, 4):
        save(d, step, tree, keep=2)
    assert valid_steps(d) == [3, 4] and latest_step(d) == 4
    os.makedirs(os.path.join(d, "step_00000009.tmp"))     # a cut save
    assert latest_step(d) == 4
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                       "layers": [{"s": torch.zeros(3)}]},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    back = restore(d, 4, like)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert back["params"]["w"].equal(tree["params"]["w"])
    assert back["params"]["layers"][0]["s"].equal(torch.ones(3))
    assert int(back["opt"]["step"]) == 4
    with pytest.raises(ValueError, match="shape"):
        restore(d, 4, {**like, "opt": {"step": torch.zeros(2)}})
    assert latest_step(str(tmp_path / "missing")) is None


def test_restart_supervisor_and_heartbeat():
    calls = []

    def make_loop():
        def loop():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("preempted")
        return loop
    waits = []
    assert run_with_restarts(make_loop, RestartPolicy(max_restarts=3),
                             sleep=waits.append) == 2
    assert waits == [1.0, 2.0]

    def broken():
        def loop():
            raise RuntimeError("always")
        return loop
    with pytest.raises(RuntimeError, match="budget exhausted"):
        run_with_restarts(broken, RestartPolicy(max_restarts=1),
                          sleep=lambda s: None)
    mon = HeartbeatMonitor()
    mon.times.extend([1.0] * 8)
    mon._last_beat -= 5.0
    rep = mon.beat(8)
    assert rep is not None and rep.factor > 2.0 and not mon.hung()


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--log-every", "1"]
    seen = []
    assert train_cli.main(argv, on_step=lambda i, m, s: seen.append(
        (i, m["loss"]))) == 0
    assert latest_step(str(tmp_path)) == 3
    assert [i for i, _ in seen] == [0, 1, 2]
    assert all(np.isfinite(x) for _, x in seen)
    capsys.readouterr()
    argv[argv.index("--steps") + 1] = "4"
    assert train_cli.main(argv) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 4


def test_train_rejects_other_families_and_a_missing_card():
    # every family trains (tests/test_torch_train_families.py, _recurrent,
    # _encdec): the family no longer decides, the device does
    (_, _), (pcfg, pparams) = _models()
    cfg = dataclasses.replace(pcfg, family="moe")
    logits, aux = T.forward_train(pparams, torch.zeros((1, 4),
                                                       dtype=torch.long), cfg)
    assert logits.shape == (1, 4, T.padded_vocab(cfg)) and float(aux) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            train_cli.main(["--arch", "internlm2_1_8b", "--smoke",
                            "--steps", "1"])
