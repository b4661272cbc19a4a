"""The tiered cache's host-side parts against the reference, on the CPU:
the eviction policies, the host tier, the cost model, page repacking
between storage dtypes, the allocator's tier half (prefetch begin /
finish / abort, the demote hook, `match_tiered`) with the injector's swap
draws, and the tier fields' validation in `EngineConfig`."""
import jax
import numpy as np
import pytest

from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.core import tiering as RTIER
from repro.serving import EngineConfig as RefEngineConfig
from repro_torch.core import paging as PG
from repro_torch.core import tiering as TIER
from repro_torch.serving import EngineConfig
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

DTYPES = ("int8", "fp8_e4m3", "int4")


def _raised(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return "ok", ""


# -- eviction policies ---------------------------------------------------------

@pytest.mark.parametrize("name", ["lru", "freq"])
def test_evictor_random_ops_identical(name):
    """A seeded random sequence of cache (with byte sizes) / uncache /
    pop_victim gives the same victims, hit counts and cached order."""
    rng = np.random.RandomState(11)
    ref, port = RTIER.make_evictor(name), TIER.make_evictor(name)
    out = []
    for _ in range(400):
        op = rng.randint(3)
        cached = list(ref)
        assert cached == list(port) and len(ref) == len(port)
        if op == 0:
            page, nb = int(rng.randint(1, 24)), int(rng.choice([1, 64, 1024]))
            if page in ref:
                continue
            for e in (ref, port):
                e.cache(page, nbytes=nb)
        elif op == 1 and cached:
            page = cached[rng.randint(len(cached))]
            for e in (ref, port):
                e.uncache(page)
        elif op == 2 and cached:
            out.append((ref.pop_victim(), port.pop_victim()))
        assert [ref.hits_of(p) for p in range(24)] == \
            [port.hits_of(p) for p in range(24)]
    assert out and all(a == b for a, b in out)


def test_make_evictor_refuses_as_reference():
    assert _raised(lambda: RTIER.make_evictor("mru")) == \
        _raised(lambda: TIER.make_evictor("mru"))
    assert isinstance(TIER.make_evictor("lru"), TIER.LRUEvictor)
    assert isinstance(TIER.make_evictor("freq"), TIER.FreqSizeEvictor)


# -- host tier -------------------------------------------------------------------

def _payloads(rng, layers=2):
    out = []
    for _ in range(layers):
        q = rng.randint(-128, 128, (8, 2, 4)).astype(np.int8)
        s = rng.rand(2, 4).astype(np.float32)
        out.append((q, s, q.copy(), s.copy()))
    return out


def test_host_tier_matches_reference():
    """put / get / drop / run_length and the capacity LRU on both tiers:
    the same return values, records, bytes and counters at every step."""
    rng = np.random.RandomState(0)
    ref, port = RTIER.HostTier(3), TIER.HostTier(3)
    digests = [bytes([d]) * 4 for d in range(6)]
    for step in range(120):
        op, h = rng.randint(4), digests[rng.randint(len(digests))]
        if op == 0:
            pay = _payloads(rng)
            got = [ref.put(h, pay, ["int8"] * 2),
                   port.put(h, [tuple(to_torch(a) for a in p) for p in pay],
                            ["int8"] * 2)]
            assert got[0] == got[1]
        elif op == 1 and h in ref:
            a, b = ref.get(h), port.get(h)
            assert (a.hits, a.nbytes, a.dtypes) == (b.hits, b.nbytes, b.dtypes)
            assert all(np.array_equal(x, to_numpy(y))
                       for pa, pb in zip(a.payloads, b.payloads)
                       for x, y in zip(pa, pb))
        elif op == 2:
            ref.drop(h)
            port.drop(h)
        chain = [digests[i] for i in rng.permutation(len(digests))]
        assert ref.run_length(chain, step % 3) == \
            port.run_length(chain, step % 3)
        assert list(ref.pages) == list(port.pages)
        assert (ref.nbytes, len(ref), ref.demotions, ref.promotions,
                ref.host_evictions, ref.lost) == \
            (port.nbytes, len(port), port.demotions, port.promotions,
             port.host_evictions, port.lost)
    assert ref.host_evictions > 0 and ref.lost > 0 and ref.promotions > 0
    for kw in (dict(capacity=0), dict(capacity=4, dtype="intX")):
        assert _raised(lambda: RTIER.HostTier(**kw)) == \
            _raised(lambda: TIER.HostTier(**kw))


@pytest.mark.parametrize("copy_cost", [1.0, 7.5, 8.0, 16.0])
def test_swap_cost_model_matches_reference(copy_cost):
    ref = RTIER.SwapCostModel(page_size=8, copy_cost_tokens=copy_cost)
    port = TIER.SwapCostModel(page_size=8, copy_cost_tokens=copy_cost)
    for n in (1, 3, 10):
        assert (ref.swap_cost(n), ref.recompute_cost(n), ref.prefer_swap(n)) \
            == (port.swap_cost(n), port.recompute_cost(n),
                port.prefer_swap(n))


# -- repacking between storage dtypes ---------------------------------------------

# scales: relative agreement with the reference's repack; values: at most
# one quantization step apart (a rounding tie decided the other way), on at
# most this fraction of the entries. A larger difference is a fault.
SCALE_RTOL = 2.2e-6
STEP_FRAC = 0.01


def _levels(q: np.ndarray, dtype: str) -> np.ndarray:
    """Stored values as integers one step apart: int8 as is, int4 its two
    nibbles, fp8 its bit pattern as signed magnitude."""
    q = np.asarray(q)
    if dtype == "fp8_e4m3":
        b = q.view(np.int8).astype(np.int32) & 0xFF
        mag = b & 0x7F
        return np.where(b & 0x80, -mag, mag)
    q = q.view(np.int8).astype(np.int32)
    if dtype == "int4":
        return np.stack([(q << 28) >> 28, q >> 4], -1)
    return q


def _page(dtype: str, seed: int):
    """Three (2 heads, 16 tokens, 32 channels) pages of ``dtype`` in pool
    layout (tokens on axis -3), from the reference's quantizer."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 2, 16, 32) * 4 * rng.rand(1, 1, 1, 32)).astype(np.float32)
    q, s = RQ.quantize_page_matrix(x, dtype)
    return np.moveaxis(np.asarray(q), -2, -3), np.asarray(s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_repack_same_dtype_is_bitwise(dtype):
    q, s = _page(dtype, 1)
    pq, ps = TIER.repack_page(to_torch(q), to_torch(s), dtype, dtype)
    assert np.array_equal(to_numpy(pq), to_numpy(to_torch(q)))
    assert np.array_equal(to_numpy(ps), s)


@pytest.mark.parametrize("src,dst", [(a, b) for a in DTYPES for b in DTYPES
                                     if a != b])
def test_repack_across_dtypes_matches_reference(src, dst):
    """Every ordered pair of storage dtypes through the f32 values: scales
    within SCALE_RTOL of the reference's, values within one step on at
    most STEP_FRAC of the entries."""
    for seed in range(3):
        q, s = _page(src, seed)
        rq, rs = RTIER.repack_page(q, s, src, dst)
        pq, ps = TIER.repack_page(to_torch(q), to_torch(s), src, dst)
        assert tuple(pq.shape) == rq.shape and tuple(ps.shape) == rs.shape
        np.testing.assert_allclose(to_numpy(ps), rs, rtol=SCALE_RTOL, atol=0)
        gap = np.abs(_levels(to_numpy(pq), dst) - _levels(rq, dst))
        assert gap.max() <= 1 and (gap > 0).mean() <= STEP_FRAC


# -- the allocator's tier half ---------------------------------------------------

def _state(a):
    return (list(a.free), dict(a.ref), dict(a.index), list(a.lru),
            dict(a.deferred), dict(a.inflight), dict(a.inflight_digests),
            sorted(a._promoted), a.hits, a.misses, a.reclaims,
            a.prefetch_issued, a.promote_hits, a.available,
            [a.lru.hits_of(p) for p in range(a.n_pages)],
            list(a.host_tier.pages), a.host_tier.lost,
            a.injector.swap_faults, a.injector.alloc_fault_ticks)


@pytest.mark.parametrize("evictor,delay,p_fail", [("lru", 0, 0.0),
                                                  ("freq", 2, 0.3),
                                                  ("lru", 1, 0.5)])
def test_allocator_with_tier_random_ops_identical(evictor, delay, p_fail):
    """A seeded random sequence of allocator operations with a host tier
    and an injector (alloc with demotion through the hook, release,
    register, adopt, match_tiered, begin / finish / abort of prefetches,
    the injector's swap draws, ticks) leaves both allocators, tiers and
    injectors in the same state after every operation, with the five
    populations partitioning the pool."""
    rng = np.random.RandomState(delay * 7 + int(p_fail * 10))
    digests = [bytes([d]) * 16 for d in range(20)]
    pay = [(np.zeros((8, 2, 4), np.int8), np.ones((2, 4), np.float32),
            np.zeros((8, 2, 4), np.int8), np.ones((2, 4), np.float32))]
    allocs, demoted = [], ([], [])
    for k, (mod, tmod) in enumerate(((RPG, RTIER), (PG, TIER))):
        tier = tmod.HostTier(6)
        a = mod.HostPageAllocator(
            12, prefix_cache=True, evictor=evictor, host_tier=tier,
            injector=mod.PoolFaultInjector(3, p_alloc_fail=0.2,
                                           p_swap_fail=p_fail,
                                           swap_delay=delay))
        plain = pay if k == 0 else [tuple(to_torch(x) for x in pay[0])]

        def hook(page, digest, tier=tier, plain=plain, log=demoted[k]):
            log.append((page, digest))
            tier.put(digest, plain, ["int8"])
        a.demote_hook = hook
        allocs.append(a)
    for _ in range(300):
        op = rng.randint(8)
        ref = allocs[0]
        if op == 0 and ref._physical:
            n = int(rng.randint(1, ref._physical + 1))
            out = [a.alloc(n) for a in allocs]
        elif op == 1 and ref.ref:
            pages = [p for p in ref.ref if rng.rand() < 0.5]
            out = [a.release(pages) for a in allocs]
        elif op == 2 and ref.ref:
            page = list(ref.ref)[rng.randint(len(ref.ref))]
            h = digests[rng.randint(len(digests))]
            if page in ref.hash_of:
                continue
            out = [a.register(page, h) for a in allocs]
        elif op == 3:
            chain = [digests[i] for i in rng.permutation(len(digests))[:4]]
            out = [(a.match(chain), a.match_tiered(chain)) for a in allocs]
            n = out[0][0]
            if n:
                out = [a.adopt(chain[:n]) for a in allocs]
        elif op == 4 and ref.available:
            hosted = [h for h in ref.host_tier.pages
                      if h not in ref.index and h not in ref.inflight_digests]
            if not hosted:
                continue
            h = hosted[rng.randint(len(hosted))]
            out = []
            for a in allocs:
                if a.injector.swap_fault():
                    a.host_tier.drop(h)
                    out.append(None)
                else:
                    out.append(a.begin_prefetch(h, a.injector.swap_delay))
        elif op == 5 and ref.inflight:
            page = sorted(ref.inflight)[0]
            out = [a.abort_prefetch(page) for a in allocs]
        elif op == 6 and ref.inflight:
            page = sorted(ref.inflight)[-1]
            out = [a.finish_prefetch(page) for a in allocs]
        else:
            out = [a.tick() for a in allocs]
        assert out[0] == out[1]
        assert _state(allocs[0]) == _state(allocs[1])
        for a in allocs:
            pops = [set(a.free), set(a.ref), set(a.lru), set(a.deferred),
                    set(a.inflight)]
            total = sum(len(p) for p in pops)
            assert total == a.n_pages - 1 == len(set().union(*pops))
    assert demoted[0] == demoted[1] and demoted[0]
    assert allocs[0].prefetch_issued > 0


def test_injector_swap_draws_identical():
    """The swap draws share the reference's stream with the per-tick
    draws: an interleaving of ticks and swap_fault calls agrees draw for
    draw."""
    ref = RPG.PoolFaultInjector(9, p_alloc_fail=0.4, p_swap_fail=0.35,
                                swap_delay=2)
    port = PG.PoolFaultInjector(9, p_alloc_fail=0.4, p_swap_fail=0.35,
                                swap_delay=2)
    rng = np.random.RandomState(2)
    for _ in range(200):
        if rng.rand() < 0.5:
            ref.tick()
            port.tick()
            assert ref.blocked == port.blocked
        else:
            assert ref.swap_fault() == port.swap_fault()
    assert (ref.swap_faults, ref.alloc_fault_ticks) == \
        (port.swap_faults, port.alloc_fault_ticks)
    assert port.swap_faults > 0 and port.swap_delay == 2


# -- EngineConfig -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(paged=True, host_pages=8),
    dict(paged=True, prefix_cache=True, host_pages=8, evictor="mru"),
    dict(paged=True, prefix_cache=True, host_tier_dtype="int4"),
    dict(paged=True, prefix_cache=True, host_pages=8,
         host_tier_dtype="intX"),
    dict(paged=True, prefix_cache=True, host_pages=0),
    dict(host_pages=4, prefix_cache=True),
    dict(evictor="freq"),
    dict(paged=True, prefix_cache=True, host_pages=8, evictor="freq",
         host_tier_dtype="int4"),
])
def test_engine_config_validates_tiering_fields(kw):
    """The tier fields raise what the reference raises (type and message)
    and are kept when valid."""
    got = [_raised(lambda: cls(batch=1, max_len=32, **kw))
           for cls in (RefEngineConfig, EngineConfig)]
    assert got[0] == got[1]
    if got[0][0] == "ok":
        c = EngineConfig(batch=1, max_len=32, **kw)
        assert (c.host_pages, c.evictor, c.host_tier_dtype) == \
            (kw.get("host_pages"), kw.get("evictor", "lru"),
             kw.get("host_tier_dtype"))


def test_host_slab_reuses_slots_after_their_records_leave():
    """The port's host slab: a record's slot returns when the record
    leaves the tier (capacity LRU or drop), not while a promotion holds
    it; with every slot held or in use, `take` adds one."""
    slab = TIER.HostSlab(2, (1, 2, 8, 2, 4), (1, 2, 2, 4), device="cpu")
    tier = TIER.HostTier(2)
    tier.on_remove = slab.release

    def demote(h):
        if len(tier) >= tier.capacity:
            tier.evict_oldest()
        slot = slab.take()
        q, s = slab.q[slot], slab.s[slot]
        tier.put(h, [(q[0, 0], s[0, 0], q[0, 1], s[0, 1])], ["int8"],
                 blocks=(q, s), slot=slot)
        return slot

    assert [demote(b"a"), demote(b"b")] == [0, 1]
    held = tier.pages[b"a"]
    slab.hold(held)
    assert demote(b"c") == 2 and len(slab.q) == 3     # a's slot held
    assert b"a" not in tier and tier.host_evictions == 1
    slab.unhold(held)
    assert slab.free == [0]
    tier.drop(b"b")
    assert sorted(slab.free) == [0, 1] and tier.lost == 1
    assert demote(b"d") in (0, 1) and len(slab.q) == 3
