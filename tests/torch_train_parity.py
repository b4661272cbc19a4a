"""Helpers of the training parity tests of the families beyond internlm's
(tests/test_torch_train_families.py, _recurrent.py, _encdec.py): both
packages' smoke models in float32 with the reference's weights bridged
(`torch_arch.smoke_models`: QKV biases and RG-LRU gate vectors seeded
non-zero; whisper_small from `encdec.init_params`), a `SyntheticLM` batch
(and `make_frames` frames for whisper), one `make_train_step` step of
each package, and the leaf-by-leaf comparison of tests/test_torch_train.py:
|a - b| <= rtol (|b| + scale max |b| of the leaf)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as ref_get_config
from repro.data import pipeline as RD
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import compression as RC
from repro.training import step as RS
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_config
from repro_torch.models import encdec as PE
from repro_torch.models import transformer as T
from repro_torch.core.tree import leaves, paths
from repro_torch.optim import AdamWConfig, compression
from repro_torch.training import step as S
from torch_arch import smoke_models
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

# Adam's eps as in tests/test_torch_train.py: the first step's update is
# sign(g) wherever |g| >> eps
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
OPT_CFG = AdamWConfig(**OPT)
RTOL = 1e-5


def models(arch: str, **replace):
    """((reference cfg, params), (port cfg, params)): fresh trees (a port
    step updates its parameters in place); ``replace`` changes fields of
    both configs that do not touch the weights (capacity_factor)."""
    if arch == "whisper_small":
        rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                   dtype="float32")
        pcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32")
        rparams = RE.init_params(rcfg, jax.random.PRNGKey(0))
        pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                           pcfg, "cpu")
    else:
        (rcfg, rparams), (pcfg, pparams) = smoke_models(arch)
    return ((dataclasses.replace(rcfg, **replace), rparams),
            (dataclasses.replace(pcfg, **replace), pparams))


def batch(cfg, B: int, S_: int, seed: int = 3) -> dict:
    """tokens / labels (B, S) from `SyntheticLM`; whisper's frames from
    `make_frames` (the same arrays in both packages)."""
    dcfg = RD.DataConfig(seq_len=S_, global_batch=B, vocab=cfg.vocab,
                         seed=seed)
    b = RD.SyntheticLM(dcfg).batch_at(0)
    if cfg.family == "encdec":
        b["frames"] = RD.make_frames(dcfg, cfg.d_model, cfg.encoder_seq)
    return b


def encode_reference(weights, batch) -> np.ndarray:
    """The reference's jitted whisper `encode` (no remat) of the
    ``frames`` of the batch npz ``batch`` on the weights npz
    ``weights`` (tests/torch_dist_worker.py's files): (B, T_enc, d)."""
    from torch_dist_worker import load_tree
    rcfg = dataclasses.replace(ref_get_config("whisper_small", smoke=True),
                               dtype="float32")
    fn = jax.jit(lambda p, f: RE.encode(p, f, rcfg, remat=False))
    return np.asarray(fn(load_tree(weights), load_tree(batch)["frames"]))


def forward_both(mods, b):
    """(reference (logits, aux), port (logits, aux)) as numpy, no remat
    (the reference's jitted)."""
    (rcfg, rp), (pcfg, pp) = mods
    if rcfg.family == "encdec":
        ref = jax.jit(lambda p, f, t: RE.forward_train(
            p, f, t, rcfg, remat=False))(rp, jnp.asarray(b["frames"]),
                                         jnp.asarray(b["tokens"]))
        port = PE.forward_train(pp, to_torch(b["frames"]),
                                to_torch(b["tokens"]), pcfg, remat=False)
    else:
        ref = jax.jit(lambda p, t: RT.forward_train(p, t, rcfg, remat=False))(
            rp, jnp.asarray(b["tokens"]))
        port = T.forward_train(pp, to_torch(b["tokens"]), pcfg, remat=False)
    return ([np.asarray(x) for x in ref],
            [x.detach().numpy() for x in port])


def step_both(mods, b, mb: int = 1, gc: bool = False):
    """One step of each package's `make_train_step` (the reference's
    jitted) from the same weights and batch: ((params, opt, metrics) of
    the reference, of the port)."""
    (rcfg, rparams), (pcfg, pparams) = mods
    ropt = RS.init_opt_state(rparams, grad_compression=gc)
    rstep = jax.jit(RS.make_train_step(rcfg, RefAdamWConfig(**OPT),
                                       microbatches=mb, grad_compression=gc))
    ref = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in b.items()})
    popt = S.init_opt_state(pparams, pcfg, grad_compression=gc)
    pstep = S.make_train_step(pcfg, OPT_CFG, microbatches=mb,
                              grad_compression=gc)
    port = pstep(pparams, popt, {k: to_torch(v) for k, v in b.items()})
    return ref, port


def pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) of two trees of one structure."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        return [x for k in sorted(ref)
                for x in pairs(port[k], ref[k], f"{path}.{k}")]
    if isinstance(ref, list):
        assert len(port) == len(ref), path
        return [x for i, (a, b) in enumerate(zip(port, ref))
                for x in pairs(a, b, f"{path}.{i}")]
    return [(path, np.asarray(port, np.float32), np.asarray(ref, np.float32))]


def close_trees(port, ref, rtol, scale=1.0, flips=0.0):
    """Leaf by leaf |a - b| <= rtol (|b| + scale max|b of the leaf|), for
    all but a fraction ``flips`` of the elements of the tree."""
    bad = total = 0
    for path, a, b in pairs(port, ref):
        assert a.shape == b.shape, path
        tol = rtol * (np.abs(b) + scale * float(np.abs(b).max()))
        n = int((np.abs(a - b) > tol).sum())
        assert flips or not n, (path, float(np.abs(a - b).max()))
        bad, total = bad + n, total + b.size
    assert bad <= flips * total, (bad, total)


def check_step(ref, port, cfg, gc: bool = False, rtol: float = RTOL,
               flips: float = 1e-4):
    """tests/test_torch_train.py's rule: loss, aux_loss, grad_norm and lr
    within ``rtol`` relative; parameters, m, v and master weights leaf by
    leaf. With ``gc``, where a gradient element lies a float32 rounding
    from a half step of its channel, the two frameworks quantize it a
    level apart: at most a fraction ``flips`` of the elements may differ
    by more, and the error state is held to rtol of its leaf's largest
    gradient (read back from the reference's m: (1 - beta1) times the
    clipped gradient), not of its own largest value, which in a one-row
    leaf (a pattern position of one group, as recurrentgemma's smoke
    blocks) is the float32 rounding of 127 steps of 1 / 127."""
    (rp, ro, rm), (pp, po, pm) = ref, port
    flips = flips if gc else 0.0
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=rtol,
                                   atol=1e-7 if k == "aux_loss" else 0,
                                   err_msg=k)
    close_trees(bridge.tree_to_numpy(pp, cfg), jax.tree.map(np.asarray, rp),
                rtol, flips=flips)
    ra = jax.tree.map(np.asarray, ro["adam"])
    assert int(po["adam"]["step"]) == int(ra["step"]) == 1
    for k in ("m", "v", "master"):
        close_trees(bridge.tree_to_numpy(po["adam"][k], cfg), ra[k], rtol,
                    flips=flips)
    assert ("grad_err" in po) == gc
    if gc:
        check_grad_err(bridge.tree_to_numpy(po["grad_err"], cfg), ro, rm,
                       rtol, flips)


def check_grad_err(err, ro, rm, rtol: float = RTOL, flips: float = 1e-4):
    """An error state (numpy, the reference's layout) against the
    reference step's: each element within rtol of its leaf's largest
    gradient (read back from the reference's m) but a fraction ``flips``
    (`check_step`)."""
    ra = jax.tree.map(np.asarray, ro["adam"])
    clip = min(1.0, OPT_CFG.grad_clip / float(rm["grad_norm"]))
    bad = total = 0
    for (path, a, b), (_, _, m) in zip(
            pairs(err, jax.tree.map(np.asarray, ro["grad_err"])),
            pairs(ra["m"], ra["m"])):
        gmax = float(np.abs(m).max()) / ((1 - OPT_CFG.beta1) * clip)
        bad += int((np.abs(a - b) > rtol * (np.abs(b) + gmax)).sum())
        total += b.size
    assert bad <= flips * total, (bad, total)


def check_compression(rparams, pcfg):
    """`compress_with_feedback` on identical numpy gradients (scales from
    1e-6 to 1 by leaf) and error states in the reference's layout of
    ``pcfg``: the compressed gradients bitwise against the jitted
    reference's, the new error state bitwise (g + e) - compressed (the
    jitted reference contracts it into a fused multiply-subtract,
    tests/test_torch_train.py), and `init_error_state` of that layout."""
    rng = np.random.RandomState(11)
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** rng.randint(-6, 1)
                   ).astype(np.float32), jax.tree.map(np.asarray, rparams))
    err = jax.tree.map(lambda g: (rng.randn(*g.shape) * 1e-3).astype(
        np.float32), grads)
    rcomp, _ = jax.jit(RC.compress_with_feedback)(grads, err)
    pgrads = bridge.params_from_numpy(grads, pcfg, "cpu")
    perr = bridge.opt_state_from_numpy(
        {"adam": {"m": grads, "v": grads, "master": grads, "step": 0},
         "grad_err": err}, pcfg, "cpu")["grad_err"]
    zero = compression.init_error_state(pgrads, pcfg)
    assert paths(zero) == paths(perr)
    assert [t.shape for t in leaves(zero)] == [t.shape for t in leaves(perr)]
    pcomp, pnew = compression.compress_with_feedback(pgrads, perr, pcfg)
    rcomp = jax.tree.map(np.asarray, rcomp)
    residual = jax.tree.map(lambda g, e, c: (g + e) - c, grads, err, rcomp)
    for (path, a, b), (_, e, r) in zip(
            pairs(bridge.tree_to_numpy(pcomp, pcfg), rcomp),
            pairs(bridge.tree_to_numpy(pnew, pcfg), residual)):
        np.testing.assert_array_equal(a, b, err_msg=path)
        np.testing.assert_array_equal(e, r, err_msg=path)
