"""The paper's quantize/dequantize kernel family of the port against the
reference, on the CPU.

The plain PyTorch versions (what `kernels.ops` gives a CPU tensor, and
what the CUDA kernels are held against on the card) equal the reference's
Pallas kernels run in interpret mode BITWISE — int8 values, float32
scales and dequantized values — on (T, D) matrices at several T, D and
block sizes, including a channel of absmax 1e-29, where the Pallas
per-channel kernel (scale clamped to 1e-30 before dividing) and the
reference's `core.quantization` path (no clamp) disagree; the port
follows the kernel. The batched (B, H, T, D) form equals
`core.quantization`'s `quantize_matrix` / `quantize_blocked` /
`dequantize[_blocked]` bitwise on ordinary data, compiled with `jax.jit`
as the reference serves them (compiled, XLA turns the scale's division by
the constant 127 into a product with float32(1/127), as in the Pallas
kernels' interpret mode; the eager reference divides, one ulp apart in
some channels). The error metrics agree within 1e-6 relative."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro.kernels import quantize as RK
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as K
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

# the reference's core quantizers as its serving path runs them: compiled
quantize_matrix = jax.jit(RQ.quantize_matrix)
quantize_blocked = jax.jit(RQ.quantize_blocked, static_argnums=1)


def _x(shape, seed=0, tiny_channel=None):
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    x[..., 0, 1] = 0.0                        # a zero at a channel's edge
    x[..., 2] = 0.0                           # an all-zero channel
    if tiny_channel is not None:              # absmax exactly 1e-29
        x[..., tiny_channel] *= np.float32(1e-29)
        x[..., 0, tiny_channel] = np.float32(1e-29)
    return x


def _bitwise(ref, port):
    a, b = to_numpy(ref), to_numpy(port)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# (T, D) cases: one per tiling edge of the Pallas picker, one tiny channel
PC_CASES = [(64, 128, None), (40, 32, None), (24, 16, 3)]
BLOCK_CASES = [(64, 128, 16, None), (48, 32, 8, None), (32, 16, 8, 3)]


@pytest.mark.parametrize("T,D,tiny", PC_CASES)
def test_quantize_per_channel_plain_matches_pallas_interpret(T, D, tiny):
    x = _x((T, D), seed=T, tiny_channel=tiny)
    rq, rs = RK.quantize_per_channel(jnp.asarray(x), interpret=True)
    pq, ps = ops.quantize_per_channel(torch.from_numpy(x))
    _bitwise(rq, pq)
    _bitwise(rs, ps)
    if tiny is not None:
        # the Pallas kernel clamps s to 1e-30 before dividing, the
        # reference's core path does not: the tiny channel quantizes apart
        cq = np.asarray(quantize_matrix(jnp.asarray(x))[0])
        assert np.abs(cq[:, tiny]).max() == 127
        assert np.abs(pq.numpy()[:, tiny]).max() == 10
        keep = np.arange(D) != tiny
        np.testing.assert_array_equal(cq[:, keep], pq.numpy()[:, keep])


@pytest.mark.parametrize("T,D,bs,tiny", BLOCK_CASES)
def test_quantize_blocked_plain_matches_pallas_interpret(T, D, bs, tiny):
    x = _x((T, D), seed=T + 1, tiny_channel=tiny)
    rq, rs = RK.quantize_blocked(jnp.asarray(x), bs, interpret=True)
    pq, ps = ops.quantize_blocked(torch.from_numpy(x), bs)
    _bitwise(rq, pq)
    _bitwise(rs, ps)


@pytest.mark.parametrize("T,D,nb,tiny", [(64, 128, 1, None), (48, 32, 6, None),
                                         (32, 16, 4, 3)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequantize_plain_matches_pallas_interpret(T, D, nb, tiny, out_dtype):
    x = _x((T, D), seed=T + 2, tiny_channel=tiny)
    q, s = RK.quantize_blocked(jnp.asarray(x), T // nb, interpret=True)
    if nb == 1:
        s = s[0]                               # a (D,) per-channel row
    ref = RK.dequantize(q, s, out_dtype=getattr(jnp, out_dtype),
                        interpret=True)
    port = ops.dequantize(to_torch(q), to_torch(s),
                          out_dtype=getattr(torch, out_dtype))
    _bitwise(ref, port)


@pytest.mark.parametrize("shape,bs", [((2, 3, 32, 16), 8),
                                      ((3, 2, 64, 128), 16)])
def test_batched_form_matches_core_quantization(shape, bs):
    x = _x(shape, seed=5)
    xt = torch.from_numpy(x)
    rq, rs = quantize_matrix(jnp.asarray(x))
    pq, ps = ops.quantize_per_channel(xt)
    _bitwise(rq, pq)
    _bitwise(rs, ps)
    _bitwise(RQ.dequantize(rq, rs), ops.dequantize(pq, ps))
    rq, rs = quantize_blocked(jnp.asarray(x), bs)
    pq, ps = ops.quantize_blocked(xt, bs)
    _bitwise(rq, pq)
    _bitwise(rs, ps)
    for dt in ("float32", "bfloat16"):
        _bitwise(RQ.dequantize_blocked(rq, rs, dtype=getattr(jnp, dt)),
                 ops.dequantize(pq, ps, out_dtype=getattr(torch, dt)))


def test_bf16_input_quantizes_as_its_float32_value():
    # the block flush quantizes the bfloat16 residual
    xb = _x((2, 3, 8, 16), seed=6).astype(ml_dtypes.bfloat16)
    rq, rs = quantize_matrix(jnp.asarray(xb))
    pq, ps = ops.quantize_blocked(to_torch(xb), 8)
    _bitwise(rq, pq)
    _bitwise(rs[..., None, :], ps)


def test_error_metrics_match_reference():
    x = _x((2, 64, 32), seed=7)
    qry = np.random.RandomState(8).uniform(-1, 1, (2, 16, 32)).astype(
        np.float32)
    rq, rs = RQ.quantize_matrix(jnp.asarray(x))
    rx = RQ.dequantize(rq, rs)
    px = Q.dequantize(to_torch(rq), to_torch(rs))
    xt, qt = torch.from_numpy(x), torch.from_numpy(qry)
    pairs = [
        (RQ.l2_error(jnp.asarray(x), rx), Q.l2_error(xt, px)),
        (RQ.max_abs_error(jnp.asarray(x), rx), Q.max_abs_error(xt, px)),
        (RQ.attention_score_error(jnp.asarray(qry), jnp.asarray(x), rx),
         Q.attention_score_error(qt, xt, px)),
        (RQ.attention_score_error_raw(jnp.asarray(qry), jnp.asarray(x), rx),
         Q.attention_score_error_raw(qt, xt, px)),
        (RQ.theoretical_max_error(rs), Q.theoretical_max_error(to_torch(rs))),
    ]
    for r, p in pairs:
        np.testing.assert_allclose(float(p), float(r), rtol=1e-6, atol=0)
    # Eq. 9 holds for the per-channel quantizer
    assert float(Q.max_abs_error(xt, px)) <= \
        float(Q.theoretical_max_error(to_torch(rs))) * (1 + 1e-6)


def test_cpu_tensors_never_reach_the_quantize_launchers():
    x = torch.from_numpy(_x((16, 16)))
    q, s = K.quantize_per_channel_plain(x)
    for call in (lambda: K.absmax_cuda(x),
                 lambda: K.quantize_with_scales_cuda(x, s),
                 lambda: K.quantize_blocked_cuda(x, 8),
                 lambda: K.dequantize_cuda(q, s)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert (K.absmax_cuda.launches, K.quantize_with_scales_cuda.launches,
            K.quantize_blocked_cuda.launches,
            K.dequantize_cuda.launches) == (0, 0, 0, 0)
