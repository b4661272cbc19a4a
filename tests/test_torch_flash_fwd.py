"""Flash attention of the port against the reference, on the CPU.

- The plain forward (`kernels.flash_fwd.flash_fwd_plain`, what
  `kernels.ops.flash_prefill` gives a CPU tensor and what the CUDA kernel
  is held against on the card) against the reference's Pallas kernel
  (`repro.kernels.flash_fwd.flash_prefill`, interpret mode: it scales the
  logits after the dot, the port before it — about an ulp apart in
  float32) and against the reference's `repro.models.flash.flash_attention`
  (the path the port follows), its m and l against `_flash_fwd_core`:
  |a - b| <= 2e-5 + 2e-5 |b| in float32. Cases: causal and not, a sliding
  window, kv_offset, GQA groups of 1 to 3, S and T no multiple of the kv
  block. In bfloat16 the port's forward holds the reference's within
  2e-3 (a probability rounded to bf16 may land one bf16 ulp apart when
  its logit differs in the last float32 bit).
- The backward (`models.flash.flash_attention`, a `torch.autograd.Function`)
  against `jax.vjp` of the reference's ``custom_vjp``: dq, dk, dv within
  1e-4 + 1e-4 |b|.
- The CUDA launcher refuses CPU tensors (the wrapper's device rule)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_fwd as RFF
from repro.models import flash as RF
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import ops
from repro_torch.models import flash
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
# (B, Hkv, G, S, T, D, causal, window, kv_offset, kv_block)
CASES = [
    (2, 2, 2, 37, 37, 16, True, None, 0, 16),
    (1, 2, 2, 24, 45, 16, False, None, 0, 16),
    (1, 1, 3, 20, 52, 32, True, 12, 32, 16),
    (2, 1, 1, 64, 64, 16, True, None, 0, 512),
    (1, 2, 2, 33, 40, 16, False, 9, 0, 8),
]
IDS = ["causal-ragged", "noncausal", "window-offset-G3", "one-block",
       "noncausal-window"]


def _qkv(B, Hkv, G, S, T, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hkv * G, S, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_reference(case):
    B, Hkv, G, S, T, D, causal, window, off, kvb = case
    q, k, v = _qkv(B, Hkv, G, S, T, D)
    out, m, l = ops.flash_prefill(to_torch(q), to_torch(k), to_torch(v),
                                  causal=causal, window=window, kv_offset=off,
                                  kv_block=kvb)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = RF.flash_attention(jq, jk, jv, causal, window, off, kvb)
    _, rm, rl = RF._flash_fwd_core(jq, jk, jv, causal, window, off, kvb)
    pallas = RFF.flash_prefill(jq, jk, jv, causal=causal, window=window,
                               kv_offset=off, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    assert m.shape == rm.shape and l.shape == rl.shape
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), **TOL)


def test_plain_forward_matches_reference_in_bfloat16():
    q, k, v = _qkv(2, 2, 2, 40, 40, 16, seed=5)
    to_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = RF.flash_attention(to_bf16(q), to_bf16(k), to_bf16(v), True, None,
                             0, 16)
    out = flash.flash_attention(*(to_torch(to_bf16(a)) for a in (q, k, v)),
                                True, None, 0, 16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_backward_matches_reference_vjp(case):
    B, Hkv, G, S, T, D, causal, window, off, kvb = case
    q, k, v = _qkv(B, Hkv, G, S, T, D, seed=1)
    dout = np.random.RandomState(2).randn(B, Hkv * G, S, D).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: RF.flash_attention(
        a, b, c, causal, window, off, kvb), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    tq, tk, tv = (to_torch(a).requires_grad_(True) for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal, window, off, kvb)
    out.backward(to_torch(dout))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_cpu_tensors_never_reach_the_flash_launcher():
    q, k, v = (to_torch(a) for a in _qkv(1, 1, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FF.flash_fwd_cuda(q, k, v)
    assert FF.flash_fwd_cuda.launches == 0
