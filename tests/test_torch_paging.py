"""The port's paged cache against the reference: the same prefill_at /
append sequence (full pages, a partial tail into the residual, flushes
through append, row masks) leaves bitwise-equal pools — except sentinel
page 0, whose contents are scatter-order garbage by design — and equal
page tables, lengths and residuals. Plus the host free-list allocator."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro_torch.core import paging as PG
from repro_torch.core import quantization as Q
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

B, H, D, PS, MAX_LEN, N_PAGES = 3, 2, 16, 8, 64, 25


def _caches(kv_dtype):
    ref = RPG.PagedQuantizedKVCache.init(
        B, H, MAX_LEN, D, RQ.QuantConfig(granularity="per_block",
                                         block_size=PS),
        n_pages=N_PAGES, kv_dtype=kv_dtype)
    port = PG.PagedQuantizedKVCache.init(
        B, H, MAX_LEN, D, Q.QuantConfig(granularity="per_block",
                                        block_size=PS),
        n_pages=N_PAGES, kv_dtype=kv_dtype, device="cpu")
    # a scrambled mapping: row b's logical block t -> a distinct page
    table = (1 + np.random.RandomState(3).permutation(N_PAGES - 1)[
        :B * (MAX_LEN // PS)]).reshape(B, -1).astype(np.int32)
    ref = dataclasses.replace(ref, page_table=jnp.asarray(table))
    port.page_table = torch.from_numpy(table)
    return ref, port


def _assert_same(ref, port):
    for name in ("k_q", "v_q", "k_s", "v_s"):
        a = to_numpy(getattr(ref.pool, name))[1:]
        b = to_numpy(getattr(port.pool, name))[1:]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(np.asarray(ref.page_table),
                                  port.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(ref.length), port.length.numpy())
    for name in ("resid_k", "resid_v"):
        assert to_numpy(getattr(ref, name)).tobytes() == \
            to_numpy(getattr(port, name)).tobytes(), name


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "int4"])
def test_prefill_at_append_sequence_bitwise(kv_dtype):
    rng = np.random.RandomState(0)
    kv = lambda T: rng.randn(2, B, H, T, D).astype(np.float32)
    ref, port = _caches(kv_dtype)

    def prefill(x, start, valid, mask):
        nonlocal ref
        start, valid, mask = (np.asarray(a) for a in (start, valid, mask))
        ref = ref.prefill_at(jnp.asarray(x[0]), jnp.asarray(x[1]),
                             jnp.asarray(start, jnp.int32),
                             row_mask=jnp.asarray(mask),
                             valid=jnp.asarray(valid, jnp.int32))
        port.prefill_at(to_torch(x[0]), to_torch(x[1]),
                        torch.from_numpy(start.astype(np.int32)),
                        row_mask=torch.from_numpy(mask),
                        valid=torch.from_numpy(valid.astype(np.int32)))
        _assert_same(ref, port)

    def append(steps, mask=None):
        nonlocal ref
        for _ in range(steps):
            x = kv(1)
            m = None if mask is None else np.asarray(mask)
            ref = ref.append(jnp.asarray(x[0]), jnp.asarray(x[1]),
                             row_mask=None if m is None else jnp.asarray(m))
            port.append(to_torch(x[0]), to_torch(x[1]),
                        row_mask=None if m is None else torch.from_numpy(m))
            _assert_same(ref, port)

    # full pages (row 0), a page + a 5-token tail (row 1), one page (row 2)
    prefill(kv(16), [0, 0, 0], [16, 13, 8], [True, True, True])
    append(4, [False, True, False])           # row 1 flushes at 8 tokens
    # row 2 continues at block 1: a page + 4 tail; rows 0/1 masked off
    prefill(kv(16), [0, 0, 1], [0, 0, 12], [False, False, True])
    append(10)                                # every row crosses a flush
    prefill(kv(8), [3, 2, 3], [8, 8, 3], [True, False, False])


def test_page_bytes_and_allocator():
    for dt in ("int8", "fp8_e4m3", "int4"):
        assert PG.page_bytes_for(256, 8, 128, dt) == \
            RPG.page_bytes_for(256, 8, 128, dt)
    a = PG.HostPageAllocator(5)
    assert a.n_free == 4
    ids = a.alloc(3)
    assert PG.SENTINEL_PAGE not in ids and len(set(ids)) == 3
    assert a.n_free == 1
    with pytest.raises(ValueError):
        a.alloc(2)
    a.release(ids[:2])
    assert a.n_free == 3 and a.ref == {ids[2]: 1}
    with pytest.raises(ValueError, match="underflow"):
        a.release(ids[:1])
    with pytest.raises(ValueError):
        PG.HostPageAllocator(1)
