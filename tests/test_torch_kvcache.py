"""The port's contiguous `QuantizedKVCache` against the reference's, on the
CPU: after init, after a prefill, and after every append of a run that
crosses a block flush, int8 values, float32 scales, bfloat16 residuals and
the length are BITWISE equal, in both granularities and as a ring (a
prefill longer than the ring, then appends that wrap). `dequantized` is
bitwise equal too, and `memory_bytes` agrees.

The reference's cache methods run compiled (`jax.jit`), as its serving
path runs them; see tests/test_torch_quantize.py for why that matters to
the last ulp of a scale. The port's prefill and flush go through the
paper's kernels (`kernels.ops.quantize_per_channel` / `quantize_blocked`;
plain versions on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as RKV
from repro.core import quantization as RQ
from repro_torch.core import kvcache as KV
from repro_torch.core import quantization as Q
from torch_parity import to_numpy

jax.config.update("jax_platform_name", "cpu")

B, H, D, BS = 2, 2, 16, 8
FIELDS = ("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v")


def _bitwise(ref, port):
    a, b = to_numpy(ref), to_numpy(port)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same(rc, pc):
    for f in FIELDS:
        _bitwise(getattr(rc, f), getattr(pc, f))
    assert int(rc.length) == pc.length


# (granularity, max_len, ring, prefill T, appends): the appends cross a
# flush (block 8) and, for the rings, the wrap past max_len
CASES = [("per_block", 32, False, 16, 10),
         ("per_channel", 32, False, 16, 10),
         ("per_block", 32, True, 40, 12),
         ("per_channel", 32, True, 40, 12)]


@pytest.mark.parametrize("gran,ML,ring,T0,n_app", CASES,
                         ids=["per_block", "per_channel", "per_block-ring",
                              "per_channel-ring"])
def test_cache_bitwise_through_prefill_and_appends(gran, ML, ring, T0,
                                                   n_app):
    rq = RQ.QuantConfig(granularity=gran, block_size=BS)
    pq = Q.QuantConfig(granularity=gran, block_size=BS)
    rng = np.random.RandomState(0)
    rc = RKV.QuantizedKVCache.init(B, H, ML, D, rq, ring=ring)
    pc = KV.QuantizedKVCache.init(B, H, ML, D, pq, ring=ring, device="cpu")
    _same(rc, pc)
    k = rng.randn(B, H, T0, D).astype(np.float32)
    v = rng.randn(B, H, T0, D).astype(np.float32)
    rc = jax.jit(lambda c, k, v: c.prefill(k, v))(rc, jnp.asarray(k),
                                                   jnp.asarray(v))
    pc.prefill(torch.from_numpy(k), torch.from_numpy(v))
    _same(rc, pc)
    append = jax.jit(lambda c, k, v: c.append(k, v))
    for _ in range(n_app):
        k = (2 * rng.randn(B, H, 1, D)).astype(np.float32)  # some clip
        v = rng.randn(B, H, 1, D).astype(np.float32)
        rc = append(rc, jnp.asarray(k), jnp.asarray(v))
        pc.append(torch.from_numpy(k), torch.from_numpy(v))
        _same(rc, pc)
    for dt in ("float32", "bfloat16"):
        for r, p in zip(rc.dequantized(getattr(jnp, dt)),
                        pc.dequantized(getattr(torch, dt))):
            _bitwise(r, p)
    assert pc.memory_bytes == rc.memory_bytes
    assert pc.max_len == rc.max_len
    assert pc.valid_len == int(rc.valid_len)


def test_fp_baseline_cache_matches():
    rng = np.random.RandomState(1)
    rc = RKV.fp_cache_init(B, H, 16, D)
    pc = KV.fp_cache_init(B, H, 16, D, device="cpu")
    k = rng.randn(B, H, 8, D).astype(np.float32)
    rc = RKV.fp_cache_prefill(rc, jnp.asarray(k), jnp.asarray(-k))
    KV.fp_cache_prefill(pc, torch.from_numpy(k), torch.from_numpy(-k))
    for _ in range(3):
        k = rng.randn(B, H, 1, D).astype(np.float32)
        rc = RKV.fp_cache_append(rc, jnp.asarray(k), jnp.asarray(k))
        KV.fp_cache_append(pc, torch.from_numpy(k), torch.from_numpy(k))
    _bitwise(rc["k"], pc["k"])
    _bitwise(rc["v"], pc["v"])
    assert int(rc["length"]) == pc["length"] == 11


def test_contiguous_cache_refuses_row_masks_and_non_int8():
    from repro_torch.configs import internlm2_1_8b
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(internlm2_1_8b.smoke(), dtype="float32")
    with pytest.raises(ValueError, match="paged"):
        T.init_decode_state(cfg, 2, 16, kv_cache_dtype="int4", device="cpu")
    state = T.init_decode_state(cfg, 2, 16, device="cpu")
    assert isinstance(state[0], KV.QuantizedKVCache)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    x = torch.zeros((2, 8, cfg.d_model))
    pos = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="paged"):
        attention.prefill(params["layers"][0]["attn"], x, cfg, pos, state[0],
                          row_mask=torch.ones(2, dtype=torch.bool))
