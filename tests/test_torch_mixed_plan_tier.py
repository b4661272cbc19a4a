"""The host tier on a mixed per-layer precision plan: the port against the
reference on the CPU (the smoke model in float32 with bridged weights,
PLAN2 = ("int8", "int4"), the reference on its Pallas kernels in
interpret mode; helpers in tests/overload_parity.py). A host record holds
each layer's page in its own format (an int4 layer in half the bytes of
the int8 one), or every layer in ``host_tier_dtype``, a layer already in
it copied as it is:

- hit == miss through a 6-page tier with ``host_tier_dtype`` None (tokens
  equal the run without a tier) and "int4" (lossy: tokens not compared);
  demotions, promotions, host bytes and every shared report key equal to
  the reference's, the host bytes the sum of the layers' payloads;
- a demoted page promoted over another page comes back byte for byte in
  every layer kept verbatim (all of them without recompression, the int4
  layer with int4 at rest), in both packages.

The split reports and the preempted rows' resumes on a plan:
tests/test_torch_mixed_plan_swap.py.
"""
import jax
import pytest

from overload_parity import Pkg, grouped_run, make_models, run_both
from repro_torch.core import paging as PG
from test_torch_mixed_plan import PLAN2
from torch_parity import pallas_interpret, to_numpy  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _page_bytes(cfg, dt):
    return PG.page_bytes_for(cfg.quant.block_size, cfg.n_kv_heads,
                             cfg.head_dim, dt)


def _verbatim_restore(pkg, b) -> list:
    """A cached page demoted under a fresh digest and promoted over
    another cached page: per layer, whether the copy equals the source
    byte for byte (values and scales); None where the record holds the
    layer recompressed."""
    a = b.allocator
    lru = list(a.lru)
    src, dst = lru[-1], lru[0]
    assert b._demote_to_host(src, b"verbatim")
    rec = b._tiering.pages[b"verbatim"]
    b._write_host_pages([dst], [rec])
    same = []
    for layer, c in enumerate(b.state["p0"] if pkg.ref else b.state):
        same.append(None if rec.dtypes[layer] != c.pool.kv_dtype else all(
            to_numpy(getattr(c.pool, n))[dst].tobytes()
            == to_numpy(getattr(c.pool, n))[src].tobytes()
            for n in ("k_q", "k_s", "v_q", "v_s")))
    return same


@pytest.mark.parametrize("host_tier_dtype", [None, "int4"])
def test_hit_equals_miss_through_host_tier_on_plan(pallas_interpret, models,
                                                   host_tier_dtype):
    """The grouped revisit workload on PLAN2 through a 6-page tier:
    records demoted and promoted, host bytes per record the sum of its
    layers' payloads, the reference's counters; without recompression the
    tokens of the run without a tier. Then a verbatim restore: every
    layer kept in its own format comes back byte for byte (with int4 at
    rest the int8 layer is recompressed and not compared)."""
    def proto(pkg):
        base = None
        if host_tier_dtype is None:
            base, _ = grouped_run(pkg, host_pages=None, kv_cache_dtype=PLAN2)
        tiered, b = grouped_run(pkg, host_pages=6, kv_cache_dtype=PLAN2,
                                host_tier_dtype=host_tier_dtype)
        rec = next(iter(b._tiering.pages.values()))
        out = [base, tiered, list(rec.dtypes), rec.nbytes]
        rep = b.pool_report()
        return out + [_verbatim_restore(pkg, b)], [rep]
    (base, tiered, dtypes, nbytes, same), (rep,) = run_both(models, proto)
    cfg = Pkg(models, ref=False).cfg
    want = [host_tier_dtype or dt for dt in PLAN2]
    assert dtypes == want
    assert nbytes == sum(_page_bytes(cfg, dt) for dt in want)
    assert rep["host_bytes"] == rep["host_pages_used"] * nbytes
    assert rep["demotions"] > 0 and rep["promotions"] > 0
    assert rep["prefetch_page_hits"] > 0 and rep["host_evictions"] > 0
    assert rep["kv_cache_dtype"] == "mixed"
    assert same == ([True, True] if host_tier_dtype is None
                    else [None, True])
    if host_tier_dtype is None:
        assert tiered == base
