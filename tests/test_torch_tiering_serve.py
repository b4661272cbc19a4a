"""The tiered cache on the port's paged path against the reference, on
the CPU: the engine protocols of tests/test_tiering.py, each run through
both packages (the smoke model in float32 with bridged weights, the
reference on its Pallas kernels in interpret mode; helpers in
tests/overload_parity.py) with identical tokens, error messages and
shared `pool_report` counters: hit == miss through the host tier with
both evictors, the split device / host accounting, int4 at rest,
the forced swap restore (greedy and seeded) against the unpressured run,
a swap fault falling back to recompute, a delayed swap riding the
in-flight population, and a demote / promote interleaving."""
import jax
import pytest

from overload_parity import Pkg, grouped_run, make_models, run_both
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def test_hit_equals_miss_through_host_tier(pallas_interpret, models):
    """Prompts served through demote + prefetch + promote give the tokens
    of a run without the tier, for both evictors and for a tier of 6
    pages (its capacity LRU drops records and their host slots are used
    again), in both packages."""
    def proto(pkg):
        base, bb = grouped_run(pkg, host_pages=None)
        out, reps = [base], [bb.pool_report()]
        for host_pages, evictor in ((32, "lru"), (32, "freq"), (6, "lru")):
            tiered, b = grouped_run(pkg, host_pages=host_pages,
                                     evictor=evictor)
            out.append(tiered)
            reps.append(b.pool_report())
        return out, reps
    (base, *tiered), (_, *reps) = run_both(models, proto)
    assert all(t == base for t in tiered)
    for rep in reps:
        assert rep["demotions"] > 0 and rep["promotions"] > 0
        assert rep["prefetch_page_hits"] > 0 and rep["page_hits"] > 0
    assert reps[-1]["host_evictions"] > 0


def test_tiny_host_tier_promotes_where_the_reference_raises(
        pallas_interpret, models):
    """A 3-page tier: a promotion's own staging page reclaims a cached
    page whose demotion pushes the record being promoted off the full
    tier. The reference raises KeyError there; the port promotes the
    bytes it still holds, and its tokens are the run's without a tier."""
    with pytest.raises(KeyError):
        grouped_run(Pkg(models, ref=True), host_pages=3)
    port = Pkg(models, ref=False)
    tiered, b = grouped_run(port, host_pages=3)
    assert tiered == grouped_run(port, host_pages=None)[0]
    rep = b.pool_report()
    assert rep["host_evictions"] > 0 and rep["prefetch_page_hits"] > 0
    assert rep["host_pages_used"] <= 3


def test_pool_and_memory_report_split_tiers(pallas_interpret, models):
    """Each tier's utilization against its own capacity, the populations
    partitioning the device pool, and `kv_cache_memory_report`'s host
    keys: equal in both packages."""
    def proto(pkg):
        _, b = grouped_run(pkg, host_pages=32)
        rep = b.pool_report()
        mem = pkg._mod.kv_cache_memory_report(b.cfg, 2, 64, scheduler=b)
        return {k: v for k, v in mem.items() if not k.startswith("ttft")}, \
            [rep]
    mem, (rep,) = run_both(models, proto)
    assert 0 <= rep["utilization"] <= 1 and 0 <= rep["host_utilization"] <= 1
    assert rep["host_pages_used"] <= rep["host_pages_capacity"] == 32
    assert rep["host_bytes"] > 0 and rep["device_bytes_live"] >= 0
    assert rep["pages_free"] + rep["pages_cached"] + rep["pages_allocated"] \
        + rep["pages_inflight"] <= rep["pages_total"]
    assert rep["evictor"] == "lru" and rep["host_tier_dtype"] is None
    assert rep["est_prefill_tokens_saved_by_swap"] > 0
    assert mem["host_tier_pages_used"] == rep["host_pages_used"]
    assert mem["host_tier_bytes"] == rep["host_bytes"]


def test_host_tier_dtype_recompression_runs(pallas_interpret, models):
    """int4 at rest: both packages complete with the same tier traffic;
    restores are lossy, so tokens are not compared (as the reference's
    test does not)."""
    def proto(pkg):
        outs, b = grouped_run(pkg, host_pages=32, host_tier_dtype="int4")
        rep = b.pool_report()
        keys = ("host_tier_dtype", "demotions", "promotions",
                "prefetch_issued", "host_pages_used", "host_bytes")
        return [len(outs), {k: rep[k] for k in keys}], []
    (n, rep), _ = run_both(models, proto)
    assert n == 6 and rep["host_tier_dtype"] == "int4"
    assert rep["demotions"] > 0 and rep["promotions"] > 0
