"""The host tier on a mixed per-layer precision plan, continued (see
tests/test_torch_mixed_plan_tier.py; PLAN2 = ("int8", "int4"), the
smoke model in float32 with bridged weights, the reference on its Pallas
kernels in interpret mode):

- the split device / host reports and `kv_cache_memory_report`'s host
  keys, equal in both packages;
- two rows (greedy and seeded) preempted mid-decode resume fast with
  their pages resident, and by swap restore after every cached page is
  reclaimed: both give the unpressured run's streams.
"""
import jax
import numpy as np
import pytest

from overload_parity import (Pkg, alloc_invariant, grouped_run, make_models,
                             run_both)
from test_torch_mixed_plan import PLAN2
from test_torch_mixed_plan_tier import _page_bytes
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def test_pool_and_memory_report_split_tiers_on_plan(pallas_interpret,
                                                    models):
    """Each tier's utilization against its own capacity and
    `kv_cache_memory_report`'s host keys on PLAN2, equal in both
    packages."""
    def proto(pkg):
        _, b = grouped_run(pkg, host_pages=32, kv_cache_dtype=PLAN2)
        mem = pkg._mod.kv_cache_memory_report(b.cfg, 2, 64, scheduler=b)
        return {k: v for k, v in mem.items() if not k.startswith("ttft")}, \
            [b.pool_report()]
    mem, (rep,) = run_both(models, proto)
    assert 0 <= rep["utilization"] <= 1 and 0 <= rep["host_utilization"] <= 1
    assert rep["host_pages_used"] <= rep["host_pages_capacity"] == 32
    assert mem["host_tier_bytes"] == rep["host_bytes"] > 0
    assert rep["device_bytes_live"] == rep["pages_live"] * sum(
        _page_bytes(Pkg(models, ref=False).cfg, dt) for dt in PLAN2)


def _submit_pair(pkg, b):
    rng = np.random.RandomState(3)
    p0 = rng.randint(0, pkg.cfg.vocab, (17,)).astype(np.int32)
    p1 = rng.randint(0, pkg.cfg.vocab, (19,)).astype(np.int32)
    b.submit(pkg.Request(uid=0, prompt=p0, sampling=pkg.SamplingParams
                         .greedy(max_new_tokens=16)))
    b.submit(pkg.Request(uid=1, prompt=p1, sampling=pkg.SamplingParams(
        temperature=0.9, seed=7, max_new_tokens=16)))


def _preempted_run(pkg, reclaim: bool):
    """Both rows, once decoding (>= 10 tokens each), preempted; with
    ``reclaim`` every evictable page is then reclaimed, so the resume
    restores from the host tier. Returns (tokens by uid, report)."""
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24, chunk=1,
                    prefix_cache=True, watermark=1, host_pages=32,
                    kv_cache_dtype=PLAN2)
    _submit_pair(pkg, b)
    outs = {}
    for _ in range(200):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        rows = [r for r in b.rows if r is not None]
        if len(rows) == 2 and not b.prefilling \
                and all(len(r.generated) >= 10 for r in rows):
            break
    assert not outs, "rows finished before the forced preemption"
    for i in (0, 1):
        b._preempt_row(i)
    a = b.allocator
    if reclaim:
        a.release(a.alloc(len(a.free) + len(a.lru)))
    assert alloc_invariant(a)
    for _ in range(400):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        if len(outs) == 2:
            break
    assert len(outs) == 2, "preempted requests did not complete"
    return outs, b.pool_report()


def test_fast_resume_and_swap_restore_on_plan(pallas_interpret, models):
    """The greedy and the seeded row on PLAN2: preempted with their pages
    resident they resume fast, preempted and reclaimed they restore from
    the host tier; both give the unpressured run's streams bit for bit."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24,
                        chunk=1, prefix_cache=True, watermark=1,
                        kv_cache_dtype=PLAN2)
        _submit_pair(pkg, b)
        base = {r.uid: list(r.generated)
                for r in b.run_to_completion(max_ticks=600)}
        fast, frep = _preempted_run(pkg, reclaim=False)
        swapped, srep = _preempted_run(pkg, reclaim=True)
        return [base, fast, swapped], [b.pool_report(), frep, srep]
    (base, fast, swapped), (_, frep, srep) = run_both(models, proto)
    assert fast == base and swapped == base
    assert frep["preempt_fast_resumes"] == 2
    assert srep["preempt_swap_restores"] == 2
    assert srep["preempt_recompute_resumes"] == 0
