"""Serving mixed per-layer KV precision plans: the port against the
reference on the CPU (float32 smoke models with bridged weights, the
reference on its Pallas kernels in interpret mode; helpers in
tests/overload_parity.py and tests/test_torch_mixed_plan.py). Tokens are
identical and every `pool_report` key the two share is equal:

- PLAN2 = ("int8", "int4") serves, with "mixed", the per-layer dtypes,
  the page-bytes-weighted capacity ratio and saved fraction in
  `pool_report`, and `kv_cache_memory_report` over the per-layer caches;
- live flips uniform -> plan -> another plan -> uniform: with a row
  resident a flip raises the reference's error, an idle one rebuilds and
  serves what an engine built on the new spec serves;
- prefix hit == miss on the plan.

A 3-layer stack: tests/test_torch_mixed_plan_stacks.py; the committed
plan on 4 layers and the serve CLI's ``--kv-cache-plan``:
tests/test_torch_mixed_plan_committed.py.
"""
import jax
import pytest

from overload_parity import Pkg, make_models, run_both
from repro_torch.core import paging as PG
from test_torch_mixed_plan import PLAN2
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _run_requests(pkg, b, uid0=0, sizes=(11, 11), max_new=5):
    for i, p in enumerate(pkg.prompts(list(sizes), seed=3)):
        b.submit(pkg.Request(uid=uid0 + i, prompt=p, sampling=pkg
                             .SamplingParams.greedy(max_new_tokens=max_new)))
    done = b.run_to_completion(max_ticks=400)
    assert len(done) == len(sizes)
    return {r.uid - uid0: list(r.generated) for r in done}


def _layer_pools(pkg, b):
    return b.state["p0"] if pkg.ref else b.state


def test_mixed_plan_serves_with_reports(pallas_interpret, models):
    """PLAN2 drains; `pool_report` says "mixed" with the per-layer dtypes
    and the page-bytes-weighted ratio and saved fraction;
    `kv_cache_memory_report` of the per-layer caches with a request in
    flight. (A fresh engine on the plan serving the same tokens is held
    by the flips test.)"""
    mem = {}

    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8,
                        kv_cache_dtype=PLAN2)
        (p,) = pkg.prompts([6])
        b.submit(pkg.Request(uid=100, prompt=p, max_new_tokens=12))
        b.step()
        mem[pkg.ref] = pkg._mod.kv_cache_memory_report(
            b.cfg, batch=2, seq=64, paged_cache=_layer_pools(pkg, b))
        b.run_to_completion(max_ticks=400)
        return _run_requests(pkg, b), [b.pool_report()]
    got, (rep,) = run_both(models, proto)
    assert all(len(v) == 5 for v in got.values())
    assert mem[False] == mem[True]
    cfg = Pkg(models, ref=False).cfg
    pb = lambda dt: PG.page_bytes_for(cfg.quant.block_size, cfg.n_kv_heads,
                                      cfg.head_dim, dt)
    assert rep["kv_cache_dtype"] == mem[False]["kv_cache_dtype"] == "mixed"
    assert rep["kv_cache_layer_dtypes"] == mem[False][
        "kv_cache_layer_dtypes"] == list(PLAN2)
    assert rep["pages_vs_int8_equal_hbm"] == pytest.approx(
        2 * pb("int8") / (pb("int8") + pb("int4")))
    assert rep["kv_page_bytes_saved_vs_int8_frac"] == pytest.approx(
        1 - (pb("int8") + pb("int4")) / (2 * pb("int8")))
    assert mem[False]["pool_page_bytes"] == (pb("int8") + pb("int4")) // 2
    assert mem[False]["pool_pages_allocated"] == -(-(8 + 12) // 8)


def test_plan_flips_midflight_raise_idle_rebuild(pallas_interpret, models):
    """uniform int8 -> PLAN2 -> ("int4", "int8") -> int8 on one batcher:
    a flip with a row resident raises (and flipping back drains), each
    idle flip serves what an engine built on the new spec serves."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, chunk=1)
        (p,) = pkg.prompts([11], seed=3)
        b.submit(pkg.Request(uid=0, prompt=p, sampling=pkg.SamplingParams
                             .greedy(max_new_tokens=8)))
        b.step()
        b.step()
        b.config.kv_cache_dtype = PLAN2
        try:
            b.step()
            error = None
        except RuntimeError as e:
            error = str(e)
        b.config.kv_cache_dtype = "int8"
        first = [list(r.generated) for r in b.run_to_completion(400)]
        out, reps = [error, first], []
        for uid0, spec in ((10, PLAN2), (20, ("int4", "int8")),
                           (30, "int8")):
            b.config.kv_cache_dtype = spec
            flipped = _run_requests(pkg, b, uid0=uid0)
            reps.append(b.pool_report())
            fresh = pkg.batcher(batch=2, max_len=64, paged=True, chunk=1,
                                kv_cache_dtype=spec)
            out += [flipped, _run_requests(pkg, fresh, uid0=uid0)]
        return out, reps
    (error, first, *runs), reps = run_both(models, proto)
    assert error and "resident" in error and len(first[0]) == 8
    assert runs[0::2] == runs[1::2]
    assert [r["kv_cache_dtype"] for r in reps] == ["mixed", "mixed", "int8"]
    assert reps[1]["kv_cache_layer_dtypes"] == ["int4", "int8"]


def test_prefix_hit_equals_miss_on_mixed_plan(pallas_interpret, models):
    """The same prompt served twice on PLAN2 with the prefix cache: the
    second adopts pages and gives the first's tokens."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefix_cache=True,
                        prefill_chunk=8, kv_cache_dtype=PLAN2)
        miss = _run_requests(pkg, b, sizes=(19,))
        hits = b.allocator.hits
        hit = _run_requests(pkg, b, uid0=5, sizes=(19,))
        return [miss, hit, b.allocator.hits > hits], [b.pool_report()]
    (miss, hit, adopted), (rep,) = run_both(models, proto)
    assert adopted and miss == hit and rep["page_hits"] > 0
