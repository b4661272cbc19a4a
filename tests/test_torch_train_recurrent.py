"""Training of the recurrent families against the reference:
recurrentgemma_9b (RG-LRU hybrid: rglru, rglru, local_attn; the smoke
config's 5 layers are one group of the pattern and a tail of two, as the
full 38 = 12 x 3 + 2) and xlstm_350m (mLSTM x 3 + sLSTM at smoke size);
smoke configs in float32, the reference's weights bridged with the RG-LRU
gate vectors seeded per channel (tests/torch_train_parity.py), sequence
32 (past recurrentgemma's smoke window of 16, so it masks).

- The mixers' gradients (with respect to every parameter and the input)
  against `jax.grad` of the reference's: `rglru.apply_seq` (the
  associative scan's interleaved writes, the conv), `xlstm.mlstm_seq` at
  one chunk and at four (the chunk-end state carried) and
  `xlstm.slstm_seq` (a token loop): within 1e-5 (|b| + max |b| of the
  leaf). `torch.maximum` and `amax` split their gradient evenly at ties,
  as JAX's `max` and `jnp.max` do (the stabilisers use them; the
  reference has no stop_gradient on them).
- `forward_train` (no remat) logits within 2e-5.
- One `make_train_step` step against the jitted reference's, under
  tests/test_torch_train.py's rule (1e-5 relative; every parameter, m, v
  and master leaf), recurrentgemma_9b also with ``grad_compression``:
  the gradients quantized in the reference's layout (blocks.p0..p2 and
  the tail), at most 1e-4 of the elements a level apart, the error state
  within 1e-5 of its leaf's largest gradient (tests/torch_train_parity.py
  says why not of its own largest value).
- `compress_with_feedback` on identical numpy gradients of the two
  models grown to 8 layers (recurrentgemma: two groups of three and a
  tail of two; xlstm: two groups of four): the compressed gradients
  bitwise against the jitted reference's, the error state bitwise
  (g + e) - compressed.
- The train CLI `--smoke --device cpu` for 2 steps, recurrentgemma_9b
  with --grad-compression.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro.configs.registry import get_config as ref_get_config
from repro.models import rglru as RR
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import rglru, xlstm
from torch_arch import seed_rglru_gates
from torch_parity import to_torch

B, SEQ = 4, 32
ARCHS = ("recurrentgemma_9b", "xlstm_350m")


def _cfgs(arch):
    return (dataclasses.replace(ref_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _grads_both(ref_fn, port_fn, rp, x, seed=5):
    """Gradients of sum(out * w) (w a fixed random tensor) with respect to
    the parameters and the input: (reference's, port's) as numpy trees."""
    rng = np.random.RandomState(seed)
    out_shape = jax.eval_shape(lambda p, v: ref_fn(p, v)[0], rp, x).shape
    w = rng.randn(*out_shape).astype(np.float32)
    rg = jax.jit(jax.grad(lambda p, v: jnp.sum(ref_fn(p, v)[0] * w),
                          argnums=(0, 1)))(rp, x)
    pp = {k: to_torch(v).requires_grad_(True) for k, v in rp.items()}
    px = to_torch(x).requires_grad_(True)
    out = port_fn(pp, px)[0]
    names = sorted(pp)
    g = torch.autograd.grad((out * to_torch(w)).sum(),
                            [pp[k] for k in names] + [px])
    port = [{k: t.numpy() for k, t in zip(names, g)}, g[-1].numpy()]
    return list(jax.tree.map(np.asarray, rg)), port


@pytest.mark.parametrize("mixer,chunk", [
    ("rglru", None), ("mlstm", 32), ("mlstm", 8), ("slstm", None)],
    ids=["rglru", "mlstm_one_chunk", "mlstm_four_chunks", "slstm"])
def test_mixer_gradients_match_jax_grad(mixer, chunk):
    arch = "recurrentgemma_9b" if mixer == "rglru" else "xlstm_350m"
    rcfg, pcfg = _cfgs(arch)
    key = jax.random.PRNGKey(11)
    x = jnp.asarray(np.random.RandomState(4).randn(
        B, SEQ, rcfg.d_model).astype(np.float32))
    if mixer == "rglru":
        rp = seed_rglru_gates({"blocks": {"p0": {"rglru": RR.init(
            rcfg, key)}}, "tail": []})["blocks"]["p0"]["rglru"]
        fns = (lambda p, v: RR.apply_seq(p, v, rcfg),
               lambda p, v: rglru.apply_seq(p, v, pcfg))
    elif mixer == "mlstm":
        rp = RX.mlstm_init(rcfg, key)
        fns = (lambda p, v: RX.mlstm_seq(p, v, rcfg, chunk=chunk),
               lambda p, v: xlstm.mlstm_seq(p, v, pcfg, chunk=chunk))
    else:
        rp = RX.slstm_init(rcfg, key)
        rp["b"] = jnp.asarray(np.random.RandomState(6).randn(
            *rp["b"].shape).astype(np.float32) * 0.5)
        fns = (lambda p, v: RX.slstm_seq(p, v, rcfg),
               lambda p, v: xlstm.slstm_seq(p, v, pcfg))
    ref, port = _grads_both(*fns, rp, x)
    P.close_trees(port, ref, P.RTOL)


def test_max_splits_its_gradient_at_ties_as_jax():
    a = np.asarray([1.0, 2.0, 3.0], np.float32)
    b = np.asarray([1.0, 5.0, 3.0], np.float32)
    rga, rgb = jax.grad(lambda x, y: jnp.sum(jnp.maximum(x, y) * 3.0),
                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (to_torch(v).requires_grad_(True) for v in (a, b))
    pga, pgb = torch.autograd.grad((torch.maximum(ta, tb) * 3.0).sum(),
                                   [ta, tb])
    np.testing.assert_array_equal(pga.numpy(), np.asarray(rga))
    np.testing.assert_array_equal(pgb.numpy(), np.asarray(rgb))
    np.testing.assert_array_equal(pga.numpy(), [1.5, 0.0, 1.5])
    m = np.asarray([[2.0, 7.0, 7.0, 1.0]], np.float32)
    rgm = jax.grad(lambda x: jnp.sum(jnp.max(x, axis=-1)))(jnp.asarray(m))
    tm = to_torch(m).requires_grad_(True)
    (pgm,) = torch.autograd.grad(tm.amax(-1).sum(), [tm])
    np.testing.assert_array_equal(pgm.numpy(), np.asarray(rgm))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    mods = P.models(arch)
    (rl, ra), (pl, pa) = P.forward_both(mods, P.batch(mods[0][0], B, SEQ))
    np.testing.assert_allclose(pl, rl, atol=2e-5, rtol=1e-5)
    assert float(pa) == float(ra) == 0.0


@pytest.mark.parametrize("arch,gc", [
    ("recurrentgemma_9b", False), ("recurrentgemma_9b", True),
    ("xlstm_350m", False)], ids=["recurrentgemma_9b",
                                 "recurrentgemma_9b_compressed",
                                 "xlstm_350m"])
def test_train_step_matches_jitted_reference(arch, gc):
    mods = P.models(arch)
    ref, port = P.step_both(mods, P.batch(mods[0][0], B, SEQ), gc=gc)
    P.check_step(ref, port, mods[1][0], gc=gc)


@pytest.mark.parametrize("arch", ARCHS)
def test_compression_is_bitwise_in_the_reference_layout(arch):
    rcfg, pcfg = (dataclasses.replace(c, n_layers=8) for c in _cfgs(arch))
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    assert len(rparams["blocks"]) == len(rcfg.block_pattern)
    assert len(rparams["tail"]) == (2 if arch == "recurrentgemma_9b" else 0)
    P.check_compression(rparams, pcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_two_steps(arch):
    seen = []
    extra = ["--grad-compression"] if arch == "recurrentgemma_9b" else []
    assert train_cli.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", str(SEQ)] + extra,
        on_step=lambda i, m, s: seen.append((i, m))) == 0
    assert [i for i, _ in seen] == [0, 1]
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for _, m in seen)
