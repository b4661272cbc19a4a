"""The seed-baseline decode entry of the port against the reference, on
the CPU.

`ops.quant_attention_decode_partials_vmap` (the plain version a CPU tensor
takes — the flat one: both TPU kernels fold tiles with the same
`_attn_update` — and what the seed CUDA kernel is held against on the
card) returns the unnormalized partials (o, m, l) of the reference's
``quant_attention_decode_partials_vmap(interpret=True)`` (one Pallas
launch per (row, kv head) under vmap) on identical numpy inputs, within
|a - b| <= 1e-5 + 1e-4 |b| in float32 (summation order: one softmax over
all slots vs the kernel's tile-by-tile online softmax). Cases: per-block
and per-channel scales, per-row lengths 0, partial, full and past T (a
ring), with and without a window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import quantization as RQ
from repro.kernels import quant_attention as RQA
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

HKV, G, D, T, BS = 2, 2, 16, 32, 8
LENGTHS = np.asarray([0, 5, 19, T, T + 13], np.int32)
TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(per_channel, seed=0):
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
@pytest.mark.parametrize("window", [None, 12])
def test_seed_entry_matches_pallas_vmap_interpret(per_channel, window):
    arrs = _inputs(per_channel, seed=int(per_channel))
    ref = RQA.quant_attention_decode_partials_vmap(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(LENGTHS), window=window,
        interpret=True)
    port = ops.quant_attention_decode_partials_vmap(
        *(to_torch(a) for a in arrs), to_torch(LENGTHS), window=window)
    for r, p in zip(ref, port):
        assert p.shape == r.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)


def test_seed_entry_checks_block_t_as_the_reference():
    arrs = [to_torch(a) for a in _inputs(False)]
    with pytest.raises(ValueError, match="must divide"):
        ops.quant_attention_decode_partials_vmap(*arrs, 7, block_t=12)
    with pytest.raises(ValueError, match="incompatible"):
        ops.quant_attention_decode_partials_vmap(*arrs, 7, block_t=16)


def test_cpu_tensors_never_reach_the_seed_launcher():
    arrs = [to_torch(a) for a in _inputs(False)]
    lens = to_torch(LENGTHS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        QA.seed_decode_partials_cuda(*arrs, lens, lens)
    assert QA.seed_decode_partials_cuda.launches == 0
