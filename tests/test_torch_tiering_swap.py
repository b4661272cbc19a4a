"""Swap restore on the port's paged path against the reference, on the
CPU: the preemption protocols of tests/test_tiering.py through both
packages (helpers in tests/overload_parity.py). Two rows (greedy and
seeded) are preempted mid-decode and every cached device page is then
reclaimed: with the host tier the resume restores the pages (bit for bit
the unpressured run's streams), without it or with every swap lost it
recomputes; a delayed swap rides the in-flight population and shows in
the stuck report; a demote / promote interleaving keeps the five page
populations a partition. Tokens, stuck reports and shared `pool_report`
counters identical in both packages."""
import jax
import numpy as np
import pytest

from overload_parity import (alloc_invariant, grouped_run, make_models,
                             run_both)
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _submit_pair(pkg, b):
    rng = np.random.RandomState(3)
    p0 = rng.randint(0, pkg.cfg.vocab, (17,)).astype(np.int32)
    p1 = rng.randint(0, pkg.cfg.vocab, (19,)).astype(np.int32)
    b.submit(pkg.Request(uid=0, prompt=p0, sampling=pkg.SamplingParams
                         .greedy(max_new_tokens=16)))
    b.submit(pkg.Request(uid=1, prompt=p1, sampling=pkg.SamplingParams(
        temperature=0.9, seed=7, max_new_tokens=16)))


def _force_swap_restore(pkg, inj=None, host_pages=32):
    """Both rows decoding (>= 10 tokens each) are preempted, then every
    evictable page is reclaimed, so the resume must restore from the host
    tier or recompute. Returns (tokens by uid, pool report)."""
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24, chunk=1,
                    prefix_cache=True, watermark=1, host_pages=host_pages,
                    fault_injector=inj)
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
    a.release(a.alloc(len(a.free) + len(a.lru)))
    assert alloc_invariant(a)
    for _ in range(400):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        if len(outs) == 2:
            break
    assert len(outs) == 2, "preempted requests did not complete"
    return outs, b.pool_report()


def test_swap_restore_bitwise_greedy_and_seeded(pallas_interpret, models):
    """The swap-restored streams equal a run never preempted, greedy and
    seeded; without a tier the same scenario recomputes and still keeps
    its streams."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24,
                        chunk=1, prefix_cache=True, watermark=1)
        _submit_pair(pkg, b)
        base = {r.uid: list(r.generated)
                for r in b.run_to_completion(max_ticks=600)}
        swapped, srep = _force_swap_restore(pkg)
        recomputed, rrep = _force_swap_restore(pkg, host_pages=None)
        return [base, swapped, recomputed], [b.pool_report(), srep, rrep]
    (base, swapped, recomputed), (_, srep, rrep) = run_both(models, proto)
    assert len(base) == 2 and swapped == base and recomputed == base
    assert srep["preempt_by_swap"] >= 1 and srep["preempt_swap_restores"] >= 1
    assert srep["promotions"] >= 1 and srep["preempt_recompute_resumes"] == 0
    assert rrep["preempt_recompute_resumes"] >= 1


def test_swap_fault_falls_back_to_recompute(pallas_interpret, models):
    """p_swap_fail=1: every promotion loses its record, the resume
    recomputes instead of stalling, and the streams are the clean run's."""
    def proto(pkg):
        faulted, frep = _force_swap_restore(
            pkg, inj=pkg.Injector(seed=5, p_swap_fail=1.0))
        clean, crep = _force_swap_restore(pkg)
        return [faulted, clean], [frep, crep]
    (faulted, clean), (rep, _) = run_both(models, proto)
    assert faulted == clean
    assert rep["injected_swap_faults"] >= 1 and rep["host_lost_records"] >= 1
    assert rep["preempt_swap_restores"] == 0
    assert rep["preempt_recompute_resumes"] >= 1


def test_swap_delay_rides_inflight_population(pallas_interpret, models):
    """swap_delay=3: promotions park in flight and the request swap-waits
    (the stuck report says so) until `tick` publishes them; the restored
    stream is the clean swap restore's."""
    def proto(pkg):
        inj = pkg.Injector(seed=5, swap_delay=3)
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24,
                        chunk=1, prefix_cache=True, watermark=1,
                        host_pages=32, fault_injector=inj)
        prompt = np.random.RandomState(3).randint(
            0, pkg.cfg.vocab, (17,)).astype(np.int32)
        b.submit(pkg.Request(uid=0, prompt=prompt, sampling=pkg
                             .SamplingParams.greedy(max_new_tokens=16)))
        for _ in range(200):
            b.step()
            r = b.rows[0]
            if r is not None and 0 not in b.prefilling \
                    and len(r.generated) >= 10:
                break
        b._preempt_row(0)
        a = b.allocator
        a.release(a.alloc(len(a.free) + len(a.lru)))
        waits, outs = [], {}
        for _ in range(400):
            for r in b.step():
                outs[r.uid] = list(r.generated)
            if a.inflight:
                assert alloc_invariant(a)
                waits.append(b._stuck_report())
            if outs:
                break
        assert not a.inflight
        clean, _ = _force_swap_restore(pkg)
        return [outs, clean[0], waits], [b.pool_report()]
    (outs, clean, waits), (rep,) = run_both(models, proto)
    assert waits and all("swap-wait" in w for w in waits)
    assert outs[0] == clean and rep["pages_inflight"] == 0


def test_demote_promote_interleaving(pallas_interpret, models):
    """Eager demotions, delayed promotions and ticks in a fixed order
    after a grouped run: the allocators' populations, tiers and counters
    agree at every step, the five populations stay a partition and the
    in-flight population drains."""
    def proto(pkg):
        _, b = grouped_run(pkg, host_pages=32)
        a, tier = b.allocator, b._tiering
        a.injector = pkg.Injector(seed=9, swap_delay=2)
        trace = []
        for step in range(12):
            if step % 3 == 0 and len(a.lru):
                page = next(iter(a.lru))
                trace.append(b._demote_to_host(page, a.hash_of[page]))
            elif step % 3 == 1:
                for h in list(tier.pages):
                    if h not in a.index and h not in a.inflight_digests \
                            and a.available > 0:
                        trace.append(b._issue_prefetch([h], 0, 1))
                        break
            else:
                a.tick()
            assert alloc_invariant(a)
            trace.append((sorted(a.free), sorted(a.lru), dict(a.inflight),
                          list(tier.pages), a.prefetch_issued))
        for _ in range(6):
            a.tick()
        assert not a.inflight and alloc_invariant(a)
        return trace, [b.pool_report()]
    trace, (rep,) = run_both(models, proto)
    assert rep["prefetch_issued"] >= 1 and rep["pages_inflight"] == 0
