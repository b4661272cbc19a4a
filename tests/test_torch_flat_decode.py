"""The flat decode kernel of the port (decode attention over the contiguous
int8 cache) against the reference, on the CPU.

The plain PyTorch version (what `kernels.ops` gives a CPU tensor, and what
the CUDA kernel is held against on the card) returns the unnormalized
partials (o, m, l) of the reference's Pallas kernel run in interpret mode
(`ops.quant_attention_decode_partials(impl="pallas_interpret")`) on
identical numpy inputs, within |a - b| <= 1e-5 + 1e-4 |b| in float32 (the
summation order differs: one softmax over all slots vs the kernel's
block-by-block online softmax). Cases: per-block and per-channel scales;
GQA groups of 1 and 2; per-row lengths 0, a partial block, the full cache
and more than T (a ring), with and without a window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro.kernels import ops as ROPS
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

HKV, D, T, BS = 2, 16, 32, 8
LENGTHS = np.asarray([0, 5, T, T + 13], np.int32)   # empty/partial/full/ring
TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(G, per_channel, seed=0):
    rng = np.random.RandomState(seed)
    B = len(LENGTHS)
    k = rng.randn(B, HKV, T, D).astype(np.float32)
    v = rng.randn(B, HKV, T, D).astype(np.float32)
    if per_channel:
        quant = lambda x: (lambda q, s: (q, s[:, :, None]))(
            *RQ.quantize_matrix(jnp.asarray(x)))
    else:
        quant = lambda x: RQ.quantize_blocked(jnp.asarray(x), BS)
    kq, ks = (np.asarray(a) for a in quant(k))
    vq, vs = (np.asarray(a) for a in quant(v))
    q = rng.randn(B, HKV * G, D).astype(np.float32)
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_block", "per_channel"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 20])
def test_flat_decode_plain_matches_pallas_interpret(per_channel, G, window):
    arrs = _inputs(G, per_channel, seed=G)
    ref = ROPS.quant_attention_decode_partials(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(LENGTHS), window=window,
        impl="pallas_interpret")
    port = ops.quant_attention_decode_partials(
        *(to_torch(a) for a in arrs), to_torch(LENGTHS), window=window)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    # an empty row still writes its partials: o = 0, m = -1e30, l = 0
    o, m, l = port
    assert float(o[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
    assert (m[0].numpy() == np.float32(-1e30)).all()


def test_window_budget_zero_masks_every_slot():
    arrs = _inputs(2, False)
    o, m, l = ops.quant_attention_decode_partials(
        *(to_torch(a) for a in arrs), to_torch(LENGTHS), window=0)
    assert float(o.abs().max()) == 0.0 and float(l.max()) == 0.0
    assert (m.numpy() == np.float32(-1e30)).all()


def test_normalized_decode_matches_pallas_interpret():
    arrs = _inputs(2, False, seed=3)
    ref = ROPS.quant_attention_decode(*(jnp.asarray(a) for a in arrs), 21,
                                      impl="pallas_interpret")
    port = ops.quant_attention_decode(*(to_torch(a) for a in arrs), 21)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_never_reach_the_flat_decode_launcher():
    arrs = [to_torch(a) for a in _inputs(2, False)]
    lens = to_torch(LENGTHS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        QA.flat_decode_partials_cuda(*arrs, lens, lens)
    assert QA.flat_decode_partials_cuda.launches == 0
