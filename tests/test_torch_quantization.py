"""Page quantizers of the port against the reference: identical inputs give
bitwise-identical page bytes and float32 scales for int8, fp8_e4m3 and
int4; plus the numeric behaviours both frameworks must share (round half
to even, the fp8 cast, arithmetic `>>` on int8, first-index argmax)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro_torch.core import quantization as Q
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["int8", "fp8_e4m3", "int4"]


def _x(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x[..., 0, 1] = 0.0                       # an all-zero-ish channel edge
    x[0, 0, :, 2] = 0.0                      # an all-zero channel
    return x


def _bitwise(ref, port):
    a, b = to_numpy(ref), to_numpy(port)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_quantize_pages_bitwise(kv_dtype):
    x = _x((2, 3, 32, 16))
    rq, rs = RQ.quantize_pages(jnp.asarray(x), 8, kv_dtype)
    pq, ps = Q.quantize_pages(torch.from_numpy(x), 8, kv_dtype)
    _bitwise(rq, pq)
    _bitwise(rs, ps)
    _bitwise(RQ.dequantize_pages(rq, rs, kv_dtype),
             Q.dequantize_pages(pq, ps, kv_dtype))


@pytest.mark.parametrize("kv_dtype,T", [(dt, 8) for dt in DTYPES]
                         + [("int4", 7)])     # odd count: int4 pads a token
def test_quantize_page_matrix_bitwise(kv_dtype, T):
    x = _x((2, 3, T, 16), seed=1)
    # the flush path quantizes the bf16 residual
    xb = x.astype(ml_dtypes.bfloat16)
    rq, rs = RQ.quantize_page_matrix(jnp.asarray(xb), kv_dtype)
    pq, ps = Q.quantize_page_matrix(to_torch(xb), kv_dtype)
    _bitwise(rq, pq)
    _bitwise(rs, ps)


def test_round_half_to_even():
    v = np.asarray([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 126.5],
                   np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(v))),
                                  torch.round(torch.from_numpy(v)).numpy())


def test_fp8_cast_bitwise():
    # every e4m3 value, the midpoints between neighbours (ties) and the
    # range edge the page quantizer can reach (absmax / scale ~ 448)
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = grid.astype(np.float32)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[1:] + vals[:-1]) / 2
    v = np.concatenate([vals, mids, [447.9, 448.0, 448.00003, -448.00003]]
                       ).astype(np.float32)
    ref = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn))
    port = torch.from_numpy(v).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(ref.view(np.int8), to_numpy(port))


def test_int8_shift_is_arithmetic_and_unpack_matches():
    b = np.arange(256, dtype=np.uint8).view(np.int8)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(b) >> 4),
                                  (torch.from_numpy(b) >> 4).numpy())
    packed = b.reshape(16, 16)
    np.testing.assert_array_equal(
        np.asarray(RQ.unpack_int4(jnp.asarray(packed))),
        Q.unpack_int4(torch.from_numpy(packed)).numpy())
    np.testing.assert_array_equal(
        np.asarray(RQ.pack_int4(RQ.unpack_int4(jnp.asarray(packed)))),
        Q.pack_int4(Q.unpack_int4(torch.from_numpy(packed))).numpy())


def test_argmax_takes_first_index_on_ties():
    x = np.asarray([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                    [0.0, -1.0, 7.0, 7.0]], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(x), -1)),
                                  torch.argmax(torch.from_numpy(x), -1)
                                  .numpy())
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(x), -1)
                                  .numpy(), [1, 0, 2])


def test_storage_layout_helpers_match():
    for dt in DTYPES:
        assert RQ.packed_tokens(8, dt) == Q.packed_tokens(8, dt)
        assert np.dtype(RQ.kv_storage_dtype(dt)).itemsize == \
            Q.kv_storage_dtype(dt).itemsize
        assert RQ.KV_QMAX[dt] == Q.KV_QMAX[dt]
    with pytest.raises(Q.QuantizationError):
        Q.packed_tokens(7, "int4")
    with pytest.raises(Q.QuantizationError):
        Q.kv_storage_dtype("int2")
