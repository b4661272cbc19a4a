"""The port's compiled dispatch (`serving.dispatch`, the scheduler's
``_decode`` / ``_chunk_fns`` / ``_sample_fn`` / ``_chunk_prefill_fns``)
on the CPU, where every step runs eagerly, against the reference's jitted
entries (the smoke model in float32 with bridged weights, the reference
on its Pallas kernels in interpret mode; helpers in
tests/overload_parity.py):

- the trace-cache key protocols of tests/test_multi_precision.py and
  tests/test_mixed_precision_plan.py through both packages: the same key
  sets, old keys surviving an idle flip, the same hist_blocks buckets,
  the full per-layer tuple under a plan;
- a long budget's chunks (32 steps and down) as calls of one scan step,
  with the reference's tokens and chunk keys;
- the shape keys a captured graph is looked up by, against what jit
  traces again on;
- address stability: every tensor a dispatch reads or writes (each
  layer's table, length, residuals and pool buffers, and the step
  inputs) keeps its address through chunked admission, prefix hits, a
  fast, a swap and a recompute resume, a watermark run and `fork_row`,
  within one state generation; no two layers share a length; an idle
  flip starts a new generation;
- the in-place cache writes (`prefill_at`, `append`, `fork_row`) against
  the reference's functional ones, bit for bit, without a tensor moving.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from overload_parity import Pkg, alloc_invariant, make_models, run_both
from repro_torch.serving.dispatch import GraphDispatch
from test_torch_paging import _assert_same, _caches
from torch_parity import pallas_interpret, to_torch  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PLAN2 = ("int8", "int4")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _run_requests(pkg, b, uid0=0, n=2, max_new=5):
    for i, p in enumerate(pkg.prompts([11] * n, seed=3)):
        b.submit(pkg.Request(uid=uid0 + i, prompt=p, sampling=pkg
                             .SamplingParams.greedy(max_new_tokens=max_new)))
    done = b.run_to_completion(max_ticks=400)
    assert len(done) == n
    return {r.uid - uid0: list(r.generated) for r in done}


def _keys(b):
    return frozenset(b._chunk_prefill_fns), frozenset(b._chunk_fns)


def test_dtype_flip_keys_match_reference(pallas_interpret, models):
    """tests/test_multi_precision.py:324-352 through both packages: after
    an idle flip to fp8_e4m3, new dtype-keyed chunk-prefill and chunk
    entries appear, the int8 keys survive, the same hist_blocks buckets
    come back, and the outputs equal a batcher born on fp8. The port's
    key sets are the reference's at each point."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8)
        first = _run_requests(pkg, b)
        before = _keys(b)
        b.config.kv_cache_dtype = "fp8_e4m3"
        flipped = _run_requests(pkg, b, uid0=10)
        fresh = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8,
                            kv_cache_dtype="fp8_e4m3")
        return [first, flipped, _run_requests(pkg, fresh, uid0=10), before,
                _keys(b), _keys(fresh)], [b.pool_report()]
    (_, flipped, fresh, (pf0, ck0), (pf1, ck1), fresh_keys), _ = \
        run_both(models, proto)
    assert pf0 and all(fused and dt == "int8" for _, fused, dt in pf0)
    assert all(dt == "int8" for _, dt in ck0)
    new = pf1 - pf0
    assert pf0 <= pf1 and ck0 <= ck1
    assert new and all(dt == "fp8_e4m3" for _, _, dt in new)
    assert {hb for hb, _, _ in new} <= {hb for hb, _, _ in pf0}
    assert flipped == fresh
    assert fresh_keys == (new, ck1 - ck0)


def test_plan_keys_carry_the_layer_tuple(pallas_interpret, models):
    """tests/test_mixed_precision_plan.py:221-233 through both packages:
    a mixed engine's chunk-prefill and chunk keys carry the full
    per-layer tuple, and equal the reference's."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8,
                        kv_cache_dtype=PLAN2)
        return [_run_requests(pkg, b), _keys(b)], [b.pool_report()]
    (got, (pf, ck)), _ = run_both(models, proto)
    assert all(len(v) == 5 for v in got.values())
    assert {dt for _, _, dt in pf} == {PLAN2}
    assert {dt for _, dt in ck} == {PLAN2}


def test_long_chunks_run_one_scan_step(pallas_interpret, models):
    """A long budget under the default chunk (no stop condition: chunks of
    32 and 16 steps) through both packages: the same tokens and the same
    ``_chunk_fns`` keys as the reference. In the port every chunk of n
    steps is n calls of the one ``_scan_step`` (what the card replays),
    so no graph's shape depends on n."""
    calls = []

    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8)
        if not pkg.ref:
            fn = b._scan_step.fn
            b._scan_step.fn = lambda *a: calls.append(1) or fn(*a)
        got = _run_requests(pkg, b, max_new=48)
        return [got, _keys(b)[1]], [b.pool_report()]
    (got, chunk_keys), _ = run_both(models, proto)
    steps = sorted(n for n, _ in chunk_keys)
    assert all(len(v) == 48 for v in got.values())
    assert len(steps) >= 2 and max(steps) >= 32
    assert len(calls) >= sum(steps)


def test_step_keys_follow_jit_retrace_rules():
    """A graph is looked up by what jit traces again on: shapes and
    dtypes (batch, chunk width), None against a tensor (masked or not,
    greedy or sampled); never by the opaque weights and state, nor by the
    values. On the CPU a step is the eager function."""
    d = GraphDispatch("cpu", enabled=False)
    step = d.step(lambda p, tok, st, pos, mask, samp: (tok + 1, st),
                  name="t", opaque=(0, 2), state_arg=2)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    samp = {"temperature": torch.zeros(2), "key": torch.zeros(2, 2).long()}
    base = ({}, i32(2, 1), [], i32(2), torch.ones(2, dtype=torch.bool), None)
    k = step.key(base)
    assert k == step.key(({"w": 1}, i32(2, 1) + 5, [1], i32(2), base[4],
                          None))
    assert k != step.key(base[:4] + (None, None))           # unmasked
    assert k != step.key(base[:5] + (samp,))                # sampled
    assert k != step.key(({}, i32(3, 1), [], i32(3), base[4][:1].repeat(3),
                          None))                            # batch
    with pytest.raises(TypeError):
        step.key(base[:5] + ([1, 2],))
    out, st = step(*base)
    assert st is base[2] and out.tolist() == [[1], [1]]
    assert not step.graphs and d.generation == 0
    d.new_generation()
    assert d.generation == 1


class _AddressTracker:
    """Wraps a port batcher's `step`: after every tick, each tensor a
    dispatch reads or writes must sit where it sat at the generation's
    first tick, and every layer must own its length."""

    def __init__(self, b):
        self.b, self.seen, self.ticks = b, {}, 0
        step = b.step

        def tracked():
            done = step()
            self.check()
            return done
        b.step = tracked

    def pointers(self) -> dict:
        b, out = self.b, {}
        for l, c in enumerate(b.state):
            for n in ("page_table", "length", "resid_k", "resid_v"):
                out[(l, n)] = getattr(c, n).data_ptr()
            for n in ("k_q", "v_q", "k_s", "v_s"):
                out[(l, "pool." + n)] = getattr(c.pool, n).data_ptr()
        for n, t in vars(b._inputs).items():       # the step inputs
            for k, x in (t.items() if isinstance(t, dict) else [(n, t)]):
                out[(n, k)] = x.data_ptr()
        return out

    def check(self):
        b = self.b
        now = self.pointers()
        seen = self.seen.setdefault(b._dispatch.generation, {})
        moved = {k for k in now.keys() & seen.keys() if now[k] != seen[k]}
        assert not moved, f"tensors moved within a generation: {moved}"
        seen.update(now)
        L = len(b.state)
        assert len({now[(l, "length")] for l in range(L)}) == L
        assert now[(0, "page_table")] == now[("table", "table")]
        self.ticks += 1


def _pair(pkg, b, uid0=0, max_new=16):
    """A greedy and a seeded request, 17 and 19 tokens (three prefill
    chunks of 8 each)."""
    p0, p1 = pkg.prompts([17, 19], seed=3)
    b.submit(pkg.Request(uid=uid0, prompt=p0, sampling=pkg.SamplingParams
                         .greedy(max_new_tokens=max_new)))
    b.submit(pkg.Request(uid=uid0 + 1, prompt=p1, sampling=pkg
                         .SamplingParams(temperature=0.9, seed=7,
                                         max_new_tokens=max_new)))


def _until_decoding(b, tokens: int, outs: dict):
    for _ in range(200):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        rows = [r for r in b.rows if r is not None]
        if len(rows) == 2 and not b.prefilling \
                and all(len(r.generated) >= tokens for r in rows):
            return
    raise AssertionError("rows did not reach decode")


def _drain(b, outs: dict, n: int):
    for _ in range(400):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        if len(outs) == n:
            return outs
    raise AssertionError("requests did not complete")


def test_dispatch_tensors_keep_their_addresses(models):
    """Chunked admission, a fast resume, a swap restore, a watermark run,
    prefix hits and `fork_row` on one tiered engine, a recompute resume on
    a second: no dispatch-visible tensor moves within a generation, no two
    layers share a length, and an idle flip starts a new generation with
    the old graphs dropped."""
    pkg = Pkg(models, ref=False)
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24, chunk=2,
                    prefill_chunk=8, prefix_cache=True, watermark=1,
                    host_pages=32)
    track = _AddressTracker(b)
    _pair(pkg, b)
    outs = {}
    _until_decoding(b, 4, outs)
    b._preempt_row(1)                         # pages stay cached: fast
    _until_decoding(b, 8, outs)
    assert b.preempt_fast_resumes == 1
    for i in (0, 1):                          # every page reclaimed: swap
        b._preempt_row(i)
    a = b.allocator
    a.release(a.alloc(len(a.free) + len(a.lru)))
    assert alloc_invariant(a)
    _drain(b, outs, 2)
    assert b.preempt_swap_restores >= 1
    _pair(pkg, b, uid0=2, max_new=4)          # the same prompts: hits
    _drain(b, outs, 4)
    assert b.pool_report()["page_hits"] > 0
    for c in b.state:
        c.fork_row(0, 1)
    track.check()
    gen = b._dispatch.generation
    b.config.kv_cache_dtype = "fp8_e4m3"
    _pair(pkg, b, uid0=4, max_new=4)
    _drain(b, outs, 6)
    assert b._dispatch.generation == gen + 1
    assert set(track.seen) == {gen, gen + 1}

    r = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24, chunk=1,
                    prefix_cache=True, watermark=1)
    rtrack = _AddressTracker(r)
    _pair(pkg, r)
    routs = {}
    _until_decoding(r, 6, routs)
    for i in (0, 1):                          # no tier: recompute
        r._preempt_row(i)
    ra = r.allocator
    ra.release(ra.alloc(len(ra.free) + len(ra.lru)))
    _drain(r, routs, 2)
    assert r.preempt_recompute_resumes >= 1
    assert track.ticks > 10 and rtrack.ticks > 10


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "int4"])
def test_in_place_cache_writes_match_reference(kv_dtype):
    """tests/test_torch_paging.py's prefill_at / append sequence with a
    `fork_row` and appends of the forked rows: the port's pools, tables,
    lengths and residuals equal the reference's functional results bit
    for bit after every write, and no port tensor changes address."""
    rng = np.random.RandomState(1)
    ref, port = _caches(kv_dtype)
    B, H, D = port.resid_k.shape[0], port.resid_k.shape[1], \
        port.resid_k.shape[-1]
    kv = lambda T: rng.randn(2, B, H, T, D).astype(np.float32)
    tensors = lambda c: [c.page_table, c.length, c.resid_k, c.resid_v,
                         c.pool.k_q, c.pool.v_q, c.pool.k_s, c.pool.v_s]
    ptrs = [t.data_ptr() for t in tensors(port)]

    def prefill(x, start, valid, mask):
        nonlocal ref
        ref = ref.prefill_at(jnp.asarray(x[0]), jnp.asarray(x[1]),
                             jnp.asarray(start, jnp.int32),
                             row_mask=jnp.asarray(mask),
                             valid=jnp.asarray(valid, jnp.int32))
        port.prefill_at(to_torch(x[0]), to_torch(x[1]),
                        torch.tensor(start, dtype=torch.int32),
                        row_mask=torch.tensor(mask),
                        valid=torch.tensor(valid, dtype=torch.int32))

    def append(steps, mask=None):
        nonlocal ref
        for _ in range(steps):
            x = kv(1)
            ref = ref.append(jnp.asarray(x[0]), jnp.asarray(x[1]),
                             row_mask=None if mask is None
                             else jnp.asarray(mask))
            port.append(to_torch(x[0]), to_torch(x[1]),
                        row_mask=None if mask is None
                        else torch.tensor(mask))
            _assert_same(ref, port)

    prefill(kv(16), [0, 0, 0], [16, 13, 8], [True, True, True])
    _assert_same(ref, port)
    append(3, [False, True, False])
    ref, _ = ref.fork_row(1, 2), port.fork_row(1, 2)
    _assert_same(ref, port)
    append(8, [True, False, True])
    prefill(kv(8), [3, 2, 3], [8, 8, 3], [True, False, False])
    _assert_same(ref, port)
    assert [t.data_ptr() for t in tensors(port)] == ptrs
