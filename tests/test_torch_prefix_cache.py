"""Automatic prefix caching of the port against the reference, on the CPU.

- `chain_hashes`: the same digests, byte for byte.
- `HostPageAllocator`: a seeded random sequence of allocator operations
  (alloc with reclaim, incref, release, register, match, adopt,
  ensure_private) leaves identical free lists, LRU orders, refcounts,
  indexes and counters, and both refuse the same invalid operations.
- The reference's protocols of tests/test_prefix_cache.py through the
  paged `ContinuousBatcher` (the smoke model in float32 with bridged
  weights, the reference on its Pallas kernels in interpret mode): hit
  against miss, a prefix shared across requests, eviction under pool
  pressure, a conversation that continues into promoted decode pages, the
  admission gate over adopted LRU pages and shared-page utilization with
  the copy-on-write scan armed. Each gives identical tokens and identical
  `pool_report` page and prefix counters. The pools (page 0, the sentinel,
  aside) agree page for page but not bit for bit: the K/V they quantize
  come out of float32 projections that XLA and torch sum in other orders,
  so scales agree within SCALE_RTOL (2.2e-6 relative at most measured)
  and an int8 value lands one step off where it sits on a rounding
  boundary (at most INT8_STEP_FRAC of them; 7.3e-4 measured, ROADMAP
  queue 3). A page holding another page's content would differ almost
  everywhere. Where the K/V are the same bits (the fork protocol below,
  tests/test_torch_paging.py) the pools are equal byte for byte.
- `fork_row` with copy-on-write: the fork protocol leaves equal tables,
  lengths, residuals and pools, and the forks stay isolated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.core import paging as RPG
from repro.models import transformer as RT
from repro.serving import ContinuousBatcher as RefBatcher
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.core import paging as PG
from repro_torch.serving import ContinuousBatcher, EngineConfig, Request
from torch_parity import pallas_interpret, to_numpy  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

SCALE_RTOL = 1e-5                # measured: 2.2e-6 (jax 0.9.0, torch 2.13)
INT8_STEP_FRAC = 5e-3            # measured: 7.3e-4 of the values, by 1
REPORT_KEYS = ("pages_total", "pages_free", "pages_cached", "pages_allocated",
               "pages_live", "page_hits", "page_misses", "page_hit_rate",
               "reclaims", "cow_retargets", "prefill_tokens_computed",
               "decode_tokens_computed", "ticks")


# -- chain_hashes ---------------------------------------------------------------

def test_chain_hashes_identical():
    rng = np.random.RandomState(0)
    for n_pages, ps in ((1, 8), (5, 8), (3, 256)):
        toks = rng.randint(0, 92544, (n_pages * ps,)).astype(np.int32)
        assert PG.chain_hashes(toks, ps) == RPG.chain_hashes(toks, ps)
        parent = RPG.chain_hashes(toks[:ps], ps)[-1]
        assert PG.chain_hashes(toks, ps, parent=parent) == \
            RPG.chain_hashes(toks, ps, parent=parent)
    assert PG.chain_hashes(np.zeros(0, np.int32), 8) == []
    for mod in (PG, RPG):
        with pytest.raises(ValueError, match="multiple"):
            mod.chain_hashes(np.arange(12), 8)


# -- the allocator ------------------------------------------------------------

def _alloc_state(a):
    return (list(a.free), dict(a.ref), dict(a.index), dict(a.hash_of),
            list(a.lru), a.hits, a.misses, a.reclaims, a.cow_retargets,
            a.n_free, a.n_cached, a.available)


def test_allocator_random_ops_identical():
    rng = np.random.RandomState(7)
    ref = RPG.HostPageAllocator(13, prefix_cache=True)
    port = PG.HostPageAllocator(13, prefix_cache=True)
    digests = RPG.chain_hashes(np.arange(20 * 8, dtype=np.int32), 8)
    errors = 0
    for step in range(600):
        op = rng.randint(7)
        held = sorted(ref.ref)
        if op == 0:
            args = ("alloc", int(rng.randint(0, 5)))
        elif op == 1 and held:
            args = ("release", [int(p) for p in
                                rng.choice(held, rng.randint(1, 3))])
        elif op == 2:
            args = ("incref", int(rng.randint(1, 13)))
        elif op == 3:
            args = ("register", int(rng.randint(1, 13)),
                    digests[rng.randint(len(digests))])
        elif op == 4:
            args = ("adopt", digests[:rng.randint(0, 6)])
        elif op == 5:
            args = ("ensure_private", int(rng.randint(1, 13)))
        else:
            args = ("match", digests[:rng.randint(0, 8)])
        name, rest = args[0], args[1:]
        if name == "adopt" and ref.match(rest[0]) < len(rest[0]):
            continue                     # adopt resolves matched digests only
        outs = []
        for a in (ref, port):
            try:
                outs.append(("ok", getattr(a, name)(*rest)))
            except ValueError:
                outs.append(("ValueError", None))
        if outs[0][0] != "ok":
            errors += 1
        assert outs[0] == outs[1], (step, args)
        assert _alloc_state(ref) == _alloc_state(port), (step, args)
        if name in ("adopt", "match"):
            assert port.available_after_adopt(rest[0]) == \
                ref.available_after_adopt(rest[0])
    assert errors and ref.reclaims and ref.cow_retargets and ref.hits


# -- serving protocols --------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(2))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


class _Pkg:
    """One package's batcher and request types behind one interface."""

    def __init__(self, models, ref: bool):
        (rcfg, rparams), (pcfg, pparams) = models
        self.ref = ref
        self.cfg, self.params = (rcfg, rparams) if ref else (pcfg, pparams)

    def batcher(self, **config):
        if self.ref:
            return RefBatcher(self.params, self.cfg, RefEngineConfig(**config))
        return ContinuousBatcher(self.params, self.cfg, EngineConfig(**config),
                                 device="cpu")

    def request(self, uid, prompt, max_new):
        cls = RefRequest if self.ref else Request
        return cls(uid=uid, prompt=prompt, max_new_tokens=max_new)

    def pools(self, b):
        """Per layer (k_q, k_s, v_q, v_s) as numpy, sentinel page dropped."""
        if self.ref:
            pool = b.state["p0"].pool
            return [tuple(np.asarray(getattr(pool, n))[l][1:]
                          for n in ("k_q", "k_s", "v_q", "v_s"))
                    for l in range(self.cfg.n_layers)]
        return [tuple(to_numpy(getattr(c.pool, n))[1:]
                      for n in ("k_q", "k_s", "v_q", "v_s"))
                for c in b.state]


def _run_both(models, protocol):
    """Run ``protocol(pkg)`` -> (tokens, reports, batcher) in both packages
    and hold the port to the reference."""
    outs = [protocol(_Pkg(models, ref)) for ref in (True, False)]
    (rt, rr, rb), (pt, pr, pb) = outs
    assert pt == rt, "token streams differ"
    assert len(pr) == len(rr)
    for a, b in zip(rr, pr):
        for k in REPORT_KEYS:
            if k in a:
                assert b[k] == a[k], (k, a[k], b[k])
    for layer, (a, b) in enumerate(zip(_Pkg(models, True).pools(rb),
                                       _Pkg(models, False).pools(pb))):
        for name, x, y in zip(("k_q", "k_s", "v_q", "v_s"), a, b):
            assert x.dtype == y.dtype, (layer, name)
            if name.endswith("_q"):
                d = np.abs(x.astype(np.int32) - y.astype(np.int32))
                assert d.max() <= 1, (layer, name)
                assert (d > 0).mean() <= INT8_STEP_FRAC, (layer, name)
            else:
                np.testing.assert_allclose(y, x, rtol=SCALE_RTOL, atol=0,
                                           err_msg=f"{layer} {name}")
    return pt, pr, pb


def _drain(b, max_ticks=400):
    return {r.uid: r.generated for r in b.run_to_completion(max_ticks)}


def test_hit_vs_miss_matches_reference(pallas_interpret, models):
    def proto(pkg):
        rng = np.random.RandomState(1)
        prompt = rng.randint(0, pkg.cfg.vocab, (40,)).astype(np.int32)
        b = pkg.batcher(batch=1, max_len=64, paged=True, prefix_cache=True,
                        prefill_chunk=16)
        b.submit(pkg.request(0, prompt, 6))
        cold = _drain(b)
        r1 = b.pool_report()
        b.submit(pkg.request(1, prompt, 6))
        warm = _drain(b)
        return [cold, warm], [r1, b.pool_report()], b
    toks, reps, _ = _run_both(models, proto)
    assert toks[0][0] == toks[1][1]
    assert reps[0]["page_hits"] == 0 and reps[1]["page_hits"] > 0
    assert reps[1]["pages_allocated"] == 0
    assert reps[1]["pages_cached"] + reps[1]["pages_free"] == \
        reps[1]["pages_total"]


def test_shared_prefix_across_requests_matches_reference(pallas_interpret,
                                                         models):
    def proto(pkg):
        rng = np.random.RandomState(3)
        shared = rng.randint(0, pkg.cfg.vocab, (32,)).astype(np.int32)
        tails = [rng.randint(0, pkg.cfg.vocab, (8,)).astype(np.int32)
                 for _ in range(3)]
        prompts = [np.concatenate([shared, t]) for t in tails]
        solo = []
        for p in prompts:
            sb = pkg.batcher(batch=1, max_len=64, paged=True,
                             prefix_cache=True, prefill_chunk=16)
            sb.submit(pkg.request(0, p, 4))
            solo.append(_drain(sb)[0])
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefix_cache=True,
                        prefill_chunk=16)
        for i, p in enumerate(prompts):
            b.submit(pkg.request(i, p, 4))
        got = _drain(b)
        assert b.allocator.ref == {}
        return [solo, got], [b.pool_report()], b
    toks, reps, _ = _run_both(models, proto)
    assert [toks[1][i] for i in range(3)] == toks[0]
    assert reps[0]["page_hits"] > 0


def test_eviction_under_pool_pressure_matches_reference(pallas_interpret,
                                                        models):
    def proto(pkg):
        rng = np.random.RandomState(5)
        pa = rng.randint(0, pkg.cfg.vocab, (24,)).astype(np.int32)
        pb = rng.randint(0, pkg.cfg.vocab, (24,)).astype(np.int32)
        b = pkg.batcher(batch=1, max_len=32, paged=True, n_pages=5,
                        prefix_cache=True, prefill_chunk=8)
        toks, reps = [], []
        for uid, p in enumerate((pa, pb, pa)):
            b.submit(pkg.request(uid, p, 4))
            toks.append(_drain(b)[uid])
            reps.append(b.pool_report())
        return toks, reps, b
    toks, reps, _ = _run_both(models, proto)
    assert toks[2] == toks[0]
    assert reps[0]["pages_cached"] > 0 and reps[1]["reclaims"] > 0


def test_conversation_continuation_matches_reference(pallas_interpret,
                                                     models):
    """Promotion on release: a prompt that continues a finished request
    (prompt + completion + a new turn) hits its decode pages."""
    def proto(pkg):
        rng = np.random.RandomState(7)
        pa = rng.randint(0, pkg.cfg.vocab, (12,)).astype(np.int32)
        b = pkg.batcher(batch=1, max_len=64, paged=True, prefix_cache=True,
                        prefill_chunk=8)
        b.submit(pkg.request(0, pa, 16))
        gen = _drain(b)[0]
        r0 = b.pool_report()
        turn = rng.randint(0, pkg.cfg.vocab, (3,)).astype(np.int32)
        follow = np.concatenate([pa, np.asarray(gen, np.int32), turn])
        b.submit(pkg.request(1, follow.astype(np.int32), 4))
        return [gen, _drain(b)[1]], [r0, b.pool_report()], b
    _, reps, _ = _run_both(models, proto)
    assert reps[1]["page_hits"] - reps[0]["page_hits"] >= 3


def test_admission_gate_over_adopted_lru_pages_matches_reference(
        pallas_interpret, models):
    def proto(pkg):
        rng = np.random.RandomState(11)
        pa = rng.randint(0, pkg.cfg.vocab, (56,)).astype(np.int32)
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=10,
                        prefix_cache=True, prefill_chunk=8)
        b.submit(pkg.request(0, pa, 8))
        first = _drain(b)
        r0 = b.pool_report()
        b.submit(pkg.request(1, pa, 8))
        b.submit(pkg.request(2, rng.randint(0, pkg.cfg.vocab, (8,))
                             .astype(np.int32), 8))
        return [first, _drain(b, 800)], [r0, b.pool_report()], b
    toks, _, _ = _run_both(models, proto)
    assert set(toks[1]) == {1, 2}


def test_shared_page_utilization_matches_reference(pallas_interpret, models):
    """Two rows share an adopted prefix with the copy-on-write scan armed:
    nothing is retargeted, and the per-tick reports agree."""
    def proto(pkg):
        rng = np.random.RandomState(12)
        shared = rng.randint(0, pkg.cfg.vocab, (32,)).astype(np.int32)
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefix_cache=True,
                        prefill_chunk=8)
        b.submit(pkg.request(0, shared, 4))
        _drain(b)
        b.chunk = 1
        b.cow_armed = True
        b.submit(pkg.request(1, shared, 16))
        b.submit(pkg.request(2, shared, 16))
        reps, done = [], {}
        for _ in range(400):
            done.update({r.uid: r.generated for r in b.step()})
            reps.append(b.pool_report())
            assert reps[-1]["utilization"] <= 1.0 + 1e-9
            if not b.queue and all(r is None for r in b.rows):
                break
        return [done], reps, b
    _, reps, _ = _run_both(models, proto)
    assert reps[-1]["cow_retargets"] == 0


def test_prefix_cache_requires_paged(models):
    _, (pcfg, pparams) = models
    for kw in (dict(prefix_cache=True), dict(prefill_chunk=8)):
        with pytest.raises(ValueError, match="paged"):
            ContinuousBatcher(pparams, pcfg, EngineConfig(
                batch=1, max_len=32, **kw), device="cpu")


# -- fork + copy-on-write -----------------------------------------------------

def test_fork_cow_isolation_matches_reference():
    """The fork protocol of tests/test_prefix_cache.py on both caches: row
    0 prefills two pages and three residual tokens, forks into row 1, and
    both append divergent tokens, retargeting a still-shared flush target
    first. Tables, lengths, residuals and pools end equal; the shared
    prefix stays one set of pages, the diverged page two."""
    from repro.core.quantization import QuantConfig as RefQuantConfig
    from repro_torch.core.quantization import QuantConfig
    H, D, ps = 2, 16, 8
    ref_alloc = RPG.HostPageAllocator(9, prefix_cache=True)
    port_alloc = PG.HostPageAllocator(9, prefix_cache=True)
    ref = RPG.PagedQuantizedKVCache.init(2, H, 32, D, RefQuantConfig(
        granularity="per_block", block_size=ps), n_pages=9)
    port = PG.PagedQuantizedKVCache.init(2, H, 32, D, QuantConfig(
        granularity="per_block", block_size=ps), n_pages=9, device="cpu")
    row0 = ref_alloc.alloc(3)
    assert port_alloc.alloc(3) == row0
    table = np.zeros((2, 4), np.int32)
    table[0, :3] = row0
    ref = dataclasses.replace(ref, page_table=jnp.asarray(table))
    port.page_table = torch.from_numpy(table.copy())
    rng = np.random.RandomState(0)

    def both(fr, fp, *arrays):
        nonlocal ref, port
        ref = fr(ref, *[jnp.asarray(a) for a in arrays])
        port = fp(port, *[torch.from_numpy(a) for a in arrays])

    kv = lambda t: rng.randn(2, H, t, D).astype(np.float32)
    m0 = np.asarray([True, False])
    both(lambda c, k, v, m: c.prefill(k, v, row_mask=m),
         lambda c, k, v, m: c.prefill_at(k, v, torch.zeros(2, dtype=torch.int32),
                                         row_mask=m), kv(16), kv(16), m0)
    for _ in range(3):
        both(lambda c, k, v, m: c.append(k, v, row_mask=m),
             lambda c, k, v, m: c.append(k, v, row_mask=m), kv(1), kv(1), m0)
    ref, port = ref.fork_row(0, 1), port.fork_row(0, 1)
    for p in row0:
        ref_alloc.incref(p)
        port_alloc.incref(p)
    for _ in range(5):
        if int(ref.length[0]) % ps == ps - 1:       # this append flushes
            tbl = np.asarray(ref.page_table).copy()
            for row in (0, 1):
                blk = int(ref.length[row]) // ps
                new = ref_alloc.ensure_private(int(tbl[row, blk]))
                assert port_alloc.ensure_private(int(tbl[row, blk])) == new
                if new is not None:
                    tbl[row, blk] = new
            ref = dataclasses.replace(ref, page_table=jnp.asarray(tbl))
            port.page_table = torch.from_numpy(tbl)
        both(lambda c, k, v: c.append(k, v), lambda c, k, v: c.append(k, v),
             kv(1), kv(1))
    assert port_alloc.cow_retargets == ref_alloc.cow_retargets == 1
    assert port_alloc.ref == ref_alloc.ref
    np.testing.assert_array_equal(port.page_table.numpy(),
                                  np.asarray(ref.page_table))
    np.testing.assert_array_equal(port.length.numpy(), np.asarray(ref.length))
    for name in ("resid_k", "resid_v"):
        assert to_numpy(getattr(port, name)).tobytes() == \
            to_numpy(getattr(ref, name)).tobytes(), name
    for name in ("k_q", "k_s", "v_q", "v_s"):
        assert to_numpy(getattr(port.pool, name))[1:].tobytes() == \
            np.asarray(getattr(ref.pool, name))[1:].tobytes(), name
    tbl = port.page_table.numpy()
    assert (tbl[0, :2] == tbl[1, :2]).all() and tbl[0, 2] != tbl[1, 2]
    kq = to_numpy(port.pool.k_q)
    assert not np.array_equal(kq[tbl[0, 2]], kq[tbl[1, 2]])
