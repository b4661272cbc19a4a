"""The plain versions of the kernels recurrentgemma_9b's path runs, at its
head width 256 and GQA group 16 (16 query heads over one kv head), against
the reference's Pallas kernels in interpret mode, on the CPU, at small S
and T (the CUDA kernels are held against these plain versions on the
card: tests/test_torch_gpu.py, chip_smoke.py):

- flat decode partials (o, m, l) over a per-block int8 ring of T = 32
  slots (block 8) whose rows have wrapped (lengths 45 and 37 > T) or not
  (20, 0), with a window of 20 shorter than the ring, and without one:
  |a - b| <= 1e-5 + 1e-4 |b| (tests/test_torch_flat_decode.py's rule);
  the empty row gives o = 0, m = -1e30, l = 0;
- the flash forward, causal with a window of 16 shorter than the prompt
  (S = T = 40, so every query past 16 has keys out of the window), also
  with kv_offset, against `repro.kernels.flash_fwd.flash_prefill` and
  `repro.models.flash.flash_attention`: |a - b| <= 2e-5 + 2e-5 |b|
  (tests/test_torch_flash_fwd.py's rule); its m and l against
  `_flash_fwd_core`;
- the blocked quantizer at D 256, blocks of 8 (the smoke ring's) and 256
  (the full config's: a prefill and a flush), bitwise against the Pallas
  kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import quantization as RQ
from repro.kernels import flash_fwd as RFF
from repro.kernels import ops as ROPS
from repro.kernels import quantize as RK
from repro.models import flash as RF
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

D, HKV, G = 256, 1, 16
DECODE_TOL = dict(atol=1e-5, rtol=1e-4)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)


def test_wide_heads_are_accepted_by_the_contiguous_kernels():
    assert D in QA.FLAT_HEAD_DIMS and D not in QA.HEAD_DIMS


@pytest.mark.parametrize("window", [20, None], ids=["window-20", "no-window"])
def test_flat_decode_wrapped_ring_matches_pallas_interpret(window):
    T, bs = 32, 8
    lengths = np.asarray([45, 37, 20, 0], np.int32)   # wrapped x2, live, empty
    rng = np.random.RandomState(11)
    B = len(lengths)
    k = rng.randn(B, HKV, T, D).astype(np.float32)
    v = rng.randn(B, HKV, T, D).astype(np.float32)
    kq, ks = (np.asarray(a) for a in RQ.quantize_blocked(jnp.asarray(k), bs))
    vq, vs = (np.asarray(a) for a in RQ.quantize_blocked(jnp.asarray(v), bs))
    q = rng.randn(B, HKV * G, D).astype(np.float32)
    arrs = (q, kq, ks, vq, vs)
    ref = ROPS.quant_attention_decode_partials(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(lengths), window=window,
        impl="pallas_interpret")
    port = ops.quant_attention_decode_partials(
        *(to_torch(a) for a in arrs), to_torch(lengths), window=window)
    for r, p in zip(ref, port):
        assert p.shape == r.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **DECODE_TOL)
    o, m, l = port
    assert float(o[3].abs().max()) == 0.0 and float(l[3].max()) == 0.0
    assert (m[3].numpy() == np.float32(-1e30)).all()
    assert float(l[:3].min()) > 0.0


@pytest.mark.parametrize("kv_offset", [0, 8])
def test_flash_forward_window_shorter_than_prompt(kv_offset):
    S, window, B = 40, 16, 1
    T = S + kv_offset
    rng = np.random.RandomState(12 + kv_offset)
    q = rng.randn(B, HKV * G, S, D).astype(np.float32)
    k = rng.randn(B, HKV, T, D).astype(np.float32)
    v = rng.randn(B, HKV, T, D).astype(np.float32)
    out, m, l = ops.flash_prefill(to_torch(q), to_torch(k), to_torch(v),
                                  causal=True, window=window,
                                  kv_offset=kv_offset, kv_block=16)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = RF.flash_attention(jq, jk, jv, True, window, kv_offset, 16)
    _, rm, rl = RF._flash_fwd_core(jq, jk, jv, True, window, kv_offset, 16)
    pallas = RFF.flash_prefill(jq, jk, jv, causal=True, window=window,
                               kv_offset=kv_offset, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FLASH_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **FLASH_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), **FLASH_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), **FLASH_TOL)


@pytest.mark.parametrize("T,bs", [(32, 8), (512, 256)],
                         ids=["smoke-block-8", "block-256"])
def test_quantize_blocked_wide_head_matches_pallas_interpret(T, bs):
    x = np.random.RandomState(T).uniform(-1, 1, (T, D)).astype(np.float32)
    rq, rs = RK.quantize_blocked(jnp.asarray(x), bs, interpret=True)
    pq, ps = ops.quantize_blocked(to_torch(x), bs)
    np.testing.assert_array_equal(to_numpy(pq), np.asarray(rq))
    np.testing.assert_array_equal(to_numpy(ps), np.asarray(rs))
