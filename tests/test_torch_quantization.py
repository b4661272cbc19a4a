"""Page quantizers of the port against the reference: identical inputs give
bitwise-identical page bytes and float32 scales for int8, fp8_e4m3 and
int4; the per-channel fp8 and int4 quantizers' dequantized float32
bitwise and `QuantConfig.compression_ratio` for every stored and
reference format; plus the numeric behaviours both frameworks must share
(round half to even, the fp8 cast, arithmetic `>>` on int8, first-index
argmax)."""
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


@pytest.mark.parametrize("fmt,T", [("fp8", 8), ("int4", 8), ("int4", 7),
                                   ("fp8", 1)])
def test_dequantize_fp8_and_int4_bitwise(fmt, T):
    """quantize_fp8 / quantize_int4 then dequantize_fp8 / dequantize_int4
    (float32 and bfloat16 out): the same bits in both packages; an odd
    int4 count comes back with its zero pad token."""
    x = _x((2, 3, T, 16), seed=2)
    rquant, rdeq = (getattr(RQ, f"quantize_{fmt}"),
                    getattr(RQ, f"dequantize_{fmt}"))
    pquant, pdeq = (getattr(Q, f"quantize_{fmt}"),
                    getattr(Q, f"dequantize_{fmt}"))
    rq, rs = rquant(jnp.asarray(x))
    pq, ps = pquant(torch.from_numpy(x))
    _bitwise(rq, pq)
    _bitwise(rs, ps)
    for rdt, pdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        _bitwise(rdeq(rq, rs, rdt), pdeq(pq, ps, pdt))
    assert pdeq(pq, ps).shape[-2] == T + (T % 2 if fmt == "int4" else 0)


@pytest.mark.parametrize("cache", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("ref", ["float32", "bfloat16", "float16", "int8"])
def test_compression_ratio_matches_reference(cache, ref):
    """`QuantConfig.compression_ratio` (reference bytes over stored bytes,
    dtypes by name in the port) equals the reference's for each pair."""
    want = RQ.QuantConfig(cache_dtype=getattr(jnp, cache),
                          ref_dtype=getattr(jnp, ref)).compression_ratio
    assert Q.QuantConfig(cache_dtype=cache,
                         ref_dtype=ref).compression_ratio == want
    assert Q.QuantConfig(cache_dtype=getattr(torch, cache),
                         ref_dtype=getattr(torch, ref)).compression_ratio \
        == want
    assert Q.QuantConfig().compression_ratio == \
        RQ.QuantConfig().compression_ratio == 2.0


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
