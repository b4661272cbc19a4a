"""Overload on the port's paged path against the reference, on the CPU:
preemption with fast and recompute resume, watermark admission, the
rejected submit, priorities and aging — the protocols of
tests/test_overload.py, each run through both packages (the smoke model
in float32 with bridged weights, the reference on its Pallas kernels in
interpret mode) with identical tokens and identical `pool_report`
counters. Plus the injector and allocator units against the reference's,
and the random interleavings property on the port alone."""
import jax
import numpy as np
import pytest

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from overload_parity import Pkg, alloc_invariant, make_models, run_both
from repro.core import paging as RPG
from repro.runtime.fault import StallWatchdog as RefStallWatchdog
from repro_torch.core import paging as PG
from repro_torch.runtime.fault import StallWatchdog
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


# -- preemption ---------------------------------------------------------------

def _parity_run(pkg, *, pressure, hold=18, span=(12, 30)):
    inj = pkg.Injector(seed=1)
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24, chunk=1,
                    prefix_cache=True, watermark=1, fault_injector=inj)
    p0, p1 = pkg.prompts([9, 11])
    b.submit(pkg.Request(uid=0, prompt=p0, sampling=pkg.SamplingParams.greedy(
        max_new_tokens=20)))
    b.submit(pkg.Request(uid=1, prompt=p1, sampling=pkg.SamplingParams(
        temperature=0.9, seed=7, max_new_tokens=20)))
    outs = {}
    for t in range(400):
        if pressure and t == span[0]:
            inj.hold_pages = hold
        if pressure and t == span[1]:
            inj.hold_pages = 0
        for r in b.step():
            outs[r.uid] = list(r.generated)
        if len(outs) == 2:
            return outs, b.pool_report()
    raise AssertionError("requests did not complete")


def test_preempt_fast_resume_matches_reference(pallas_interpret, models):
    """A forced preemption and fast resume give the unpressured run's
    greedy and seeded streams, in both packages alike."""
    def proto(pkg):
        base, brep = _parity_run(pkg, pressure=False)
        pres, prep = _parity_run(pkg, pressure=True)
        return [base, pres], [brep, prep]
    (base, pres), (brep, prep) = run_both(models, proto)
    assert brep["preemptions"] == 0
    assert prep["preemptions"] >= 1 and prep["preempt_fast_resumes"] >= 1
    assert pres == base


def test_recompute_resume_matches_reference(pallas_interpret, models):
    """The suspended row's cached pages are reclaimed before re-admission:
    the resume prefills prompt + generated again and restores the pending
    token, so the stream continues where it stopped."""
    def proto(pkg):
        inj = pkg.Injector(seed=1)
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24,
                        chunk=1, prefix_cache=True, watermark=1,
                        fault_injector=inj)
        p0, p1 = pkg.prompts([9, 11])
        for uid, p in enumerate((p0, p1)):
            b.submit(pkg.Request(uid=uid, prompt=p, sampling=pkg
                                 .SamplingParams.greedy(max_new_tokens=20)))
        outs, snap = {}, None
        for t in range(400):
            if t == 12:
                inj.hold_pages = 18
            if t == 16 and b._suspended and snap is None:
                uid = next(iter(b._suspended))
                s = b._suspended[uid]
                snap = (uid, [int(x) for x in s["full_toks"]],
                        s["pending"], len((p0, p1)[uid]))
                inj.hold_pages = 0
                b.allocator.release(b.allocator.alloc(b.allocator.available))
            for r in b.step():
                outs[r.uid] = list(r.generated)
            if len(outs) == 2:
                break
        return [outs, snap], [b.pool_report()]
    (outs, snap), (rep,) = run_both(models, proto)
    assert rep["preemptions"] >= 1 and rep["preempt_recompute_resumes"] >= 1
    uid, full, pending, S = snap
    n = len(full) - S
    assert outs[uid][:n] == full[S:]
    assert outs[uid][n] == pending
    assert len(outs[uid]) == 20


# -- watermark admission ------------------------------------------------------

def test_optimistic_admission_matches_reference(pallas_interpret, models):
    """A watermark reserves prompt + watermark pages, so all four rows
    admit where the worst case admits two; the oversubscribed mix drains
    by preempting."""
    def proto(pkg):
        out, reps = [], []
        for watermark in (None, 1):
            b = pkg.batcher(batch=4, max_len=64, paged=True, n_pages=9,
                            chunk=1, watermark=watermark)
            for u, p in enumerate(pkg.prompts([8, 8, 8, 8])):
                b.submit(pkg.Request(uid=u, prompt=p, sampling=pkg
                                     .SamplingParams.greedy(
                                         max_new_tokens=24)))
            b.step()
            out.append(sum(r is not None for r in b.rows))
        done = b.run_to_completion(max_ticks=2000)
        out.append({r.uid: r.generated for r in done})
        return out, [b.pool_report()]
    (worst, opt, done), (rep,) = run_both(models, proto)
    assert opt == 4 > worst
    assert sorted(done) == [0, 1, 2, 3]
    assert all(len(g) == 24 for g in done.values())
    assert rep["preemptions"] >= 1


def test_no_watermark_keeps_overload_cold_as_reference(pallas_interpret,
                                                       models):
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=24,
                        chunk=1, prefix_cache=True)
        for u, p in enumerate(pkg.prompts([9, 11])):
            b.submit(pkg.Request(uid=u, prompt=p, sampling=pkg
                                 .SamplingParams.greedy(max_new_tokens=12)))
        done = b.run_to_completion(max_ticks=400)
        return {r.uid: r.generated for r in done}, [b.pool_report()]
    _, (rep,) = run_both(models, proto)
    assert rep["preemptions"] == rep["preempt_fast_resumes"] == 0
    assert rep["decode_stall_ticks"] == 0


def test_rejected_submit_leaves_state_as_reference(pallas_interpret, models):
    """A request that cannot be served and a duplicate uid raise before
    anything changes: the queue, the report and the request stay as they
    were."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=16,
                        chunk=1, prefix_cache=True)
        (p0,) = pkg.prompts([9])
        greedy = pkg.SamplingParams.greedy
        b.submit(pkg.Request(uid=0, prompt=p0,
                             sampling=greedy(max_new_tokens=4)))
        b.step()
        before = (b.pool_report(), [(r.uid, r._arrival) for r in b.queue],
                  b._seq)
        bad = pkg.Request(uid=99, prompt=np.arange(60, dtype=np.int32),
                          sampling=greedy(max_new_tokens=60))
        dup = pkg.Request(uid=0, prompt=p0,
                          sampling=greedy(max_new_tokens=4))
        errors = []
        for req in (bad, dup):
            with pytest.raises(ValueError) as e:
                b.submit(req)
            errors.append(str(e.value))
        after = (b.pool_report(), [(r.uid, r._arrival) for r in b.queue],
                 b._seq)
        strip = lambda d: {k: v for k, v in d.items()
                           if not k.startswith("ttft")}
        assert strip(after[0]) == strip(before[0])
        assert after[1:] == before[1:]
        assert bad.submit_time is None and bad.max_new_tokens is None
        assert 99 not in b._inflight_uids
        return errors, [before[0], after[0]]
    run_both(models, proto)


# -- priorities and aging -----------------------------------------------------

def test_priority_orders_admission_as_reference(pallas_interpret, models):
    """One row: the priority-5 request (`LLMEngine.add_request(priority=)`
    over its SamplingParams) finishes first whatever the submit order."""
    def proto(pkg):
        eng = pkg.engine(batch=1, max_len=64, paged=True, n_pages=16,
                         chunk=1)
        lo, hi = pkg.prompts([9, 11])
        greedy = pkg.SamplingParams.greedy
        u_lo = eng.add_request(lo, greedy(max_new_tokens=4))
        u_hi = eng.add_request(hi, greedy(max_new_tokens=4), priority=5)
        order, toks = [], {}
        for _ in range(200):
            for o in eng.step():
                if o.finished:
                    order.append(o.uid)
                    toks[o.uid] = o.token_ids
            if len(order) == 2:
                break
        assert order == [u_hi, u_lo]
        return [order, toks], [eng.pool_report()]
    run_both(models, proto)


def test_aging_prevents_starvation_as_reference(pallas_interpret, models):
    """A priority-0 request behind a stream of priority-3 arrivals is
    served last without aging and earlier with ``aging_ticks=1``."""
    def proto(pkg):
        ranks, reps = [], []
        for aging_ticks in (0, 1):
            b = pkg.batcher(batch=1, max_len=64, paged=True, n_pages=16,
                            chunk=1, aging_ticks=aging_ticks)
            prompts = pkg.prompts([9, 9, 9, 9, 9])
            hi = lambda u: pkg.Request(uid=u, prompt=prompts[u],
                                       sampling=pkg.SamplingParams(
                                           temperature=0.0, priority=3,
                                           max_new_tokens=4))
            b.submit(hi(1))
            b.submit(pkg.Request(uid=0, prompt=prompts[0], sampling=pkg
                                 .SamplingParams.greedy(max_new_tokens=4)))
            order, pending = [], {2: 2, 4: 3, 6: 4}
            for _ in range(2000):
                if b.ticks in pending:
                    b.submit(hi(pending.pop(b.ticks)))
                order += [r.uid for r in b.step()]
                if len(order) == 5:
                    break
            ranks.append(order)
            reps.append(b.pool_report())
        return ranks, reps
    (no_aging, aging), _ = run_both(models, proto)
    assert no_aging.index(0) == 4
    assert aging.index(0) < 4


# -- the injector, the allocator and the watchdog -----------------------------

@pytest.mark.parametrize("seed,p", [(0, 0.5), (11, 0.5), (3, 0.2), (7, 1.0),
                                    (5, 0.0)])
def test_injector_blocks_the_reference_ticks(seed, p):
    """The same seed blocks the same ticks as the reference's injector."""
    ref = RPG.PoolFaultInjector(seed, p_alloc_fail=p)
    port = PG.PoolFaultInjector(seed, p_alloc_fail=p)
    seq = []
    for _ in range(300):
        ref.tick()
        port.tick()
        seq.append(port.blocked)
        assert port.blocked == ref.blocked
    assert port.alloc_fault_ticks == ref.alloc_fault_ticks == sum(seq)


@pytest.mark.parametrize("kw", [dict(p_alloc_fail=1.5), dict(hold_pages=-1),
                                dict(reclaim_delay=-2), dict(p_swap_fail=2.0),
                                dict(swap_delay=-1)])
def test_injector_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        RPG.PoolFaultInjector(0, **kw)
    with pytest.raises(ValueError):
        PG.PoolFaultInjector(0, **kw)


@pytest.mark.parametrize("kw", [dict(p_swap_fail=0.25), dict(swap_delay=2)])
def test_injector_swap_knobs_wait_for_the_host_tier(kw):
    """The host tier's knobs, ported with the tier: accepted as the
    reference accepts them, and the swap draws are the reference's."""
    ref, port = RPG.PoolFaultInjector(0, **kw), PG.PoolFaultInjector(0, **kw)
    assert (port.p_swap_fail, port.swap_delay) == \
        (ref.p_swap_fail, ref.swap_delay)
    assert [ref.swap_fault() for _ in range(40)] == \
        [port.swap_fault() for _ in range(40)]
    assert port.swap_faults == ref.swap_faults


def _state(a):
    return (list(a.free), dict(a.ref), dict(a.index), list(a.lru),
            dict(a.deferred), a.hits, a.misses, a.reclaims, a.cow_retargets,
            a.available, a._physical, a.injector.alloc_fault_ticks,
            a.injector.delayed_releases, a.injector.blocked)


@pytest.mark.parametrize("delay,p", [(0, 0.3), (2, 0.0), (3, 0.4)])
def test_allocator_with_injector_random_ops_identical(delay, p):
    """A seeded random sequence of allocator operations with an injector
    (tick, hold and let go, alloc, release into the deferred population,
    register, adopt a deferred or cached page, ensure_private) leaves both
    allocators in the same state after every operation, and free + ref +
    lru + deferred partition the pool throughout."""
    rng = np.random.RandomState(delay * 10 + int(p * 10))
    allocs = [mod.HostPageAllocator(13, prefix_cache=True,
                                    injector=mod.PoolFaultInjector(
                                        4, p_alloc_fail=p,
                                        reclaim_delay=delay))
              for mod in (RPG, PG)]
    ref, port = allocs
    digests = RPG.chain_hashes(np.arange(20 * 8, dtype=np.int32), 8)
    for step in range(500):
        op = rng.randint(8)
        held = sorted(ref.ref)
        if op == 0:
            args = ("tick",)
        elif op == 1:
            args = ("hold", int(rng.randint(0, 8)))
        elif op == 2:
            args = ("alloc", int(rng.randint(0, 4)))
        elif op == 3 and held:
            args = ("release", [int(x) for x in
                                rng.choice(held, rng.randint(1, 3))])
        elif op == 4 and held:           # a written page is referenced
            args = ("register", int(rng.choice(held)),
                    digests[rng.randint(6)])
        elif op == 5:
            args = ("adopt", digests[:rng.randint(0, 5)])
        elif op == 6:
            args = ("ensure_private", int(rng.randint(1, 13)))
        else:
            args = ("available_after_adopt", digests[:rng.randint(0, 6)])
        name, rest = args[0], args[1:]
        if name == "adopt" and ref.match(rest[0]) < len(rest[0]):
            continue
        outs = []
        for a in allocs:
            if name == "hold":
                a.injector.hold_pages = rest[0]
                outs.append(("ok", None))
                continue
            try:
                outs.append(("ok", getattr(a, name)(*rest)))
            except ValueError:
                outs.append(("ValueError", None))
        assert outs[0] == outs[1], (step, args)
        assert _state(port) == _state(ref), (step, args)
        assert alloc_invariant(port), (step, args)
    assert port.reclaims and port.hits and port.cow_retargets
    assert bool(port.injector.delayed_releases) == bool(delay)
    assert bool(port.injector.alloc_fault_ticks) == bool(p)


@pytest.mark.parametrize("limit", [None, 1, 3])
def test_stall_watchdog_matches_reference(limit):
    rng = np.random.RandomState(limit or 0)
    ref, port = RefStallWatchdog(limit), StallWatchdog(limit)
    for _ in range(200):
        progressed, busy = bool(rng.rand() < 0.2), bool(rng.rand() < 0.8)
        assert port.observe(progressed, busy) == \
            ref.observe(progressed, busy)
        assert port.stalled_ticks == ref.stalled_ticks
    for cls in (RefStallWatchdog, StallWatchdog):
        with pytest.raises(ValueError, match="stall limit"):
            cls(0)


# -- random interleavings (the port alone) ------------------------------------

@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=5, deadline=None)
@given(st.data())
def test_random_interleavings_keep_accounting_and_terminate(models, data):
    """Random submit / abort / squeeze / lift / tick interleavings at mixed
    priorities on the port: after every operation free + ref + lru +
    deferred partition the pool, and once the pressure lifts every
    request not aborted completes (no deadlock, no starvation). Requests
    that finish in a tick of the interleaving count as completed."""
    pkg = Pkg(models, ref=False)
    inj = pkg.Injector(
        seed=data.draw(st.integers(0, 2**16), label="inj_seed"),
        reclaim_delay=data.draw(st.integers(0, 2), label="delay"))
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=14, chunk=1,
                    prefix_cache=True, watermark=1, aging_ticks=3,
                    fault_injector=inj)
    rng = np.random.RandomState(data.draw(st.integers(0, 2**16),
                                          label="prompt_seed"))
    uid, live, finished = 0, set(), set()
    for op in data.draw(st.lists(st.sampled_from(
            ["submit", "abort", "tick", "squeeze", "lift"]),
            min_size=6, max_size=14), label="ops"):
        if op == "submit" and len(live - finished) < 5:
            b.submit(pkg.Request(
                uid=uid, prompt=rng.randint(
                    0, pkg.cfg.vocab, (rng.randint(3, 17),)).astype(np.int32),
                sampling=pkg.SamplingParams(
                    temperature=0.0, max_new_tokens=int(rng.randint(2, 9)),
                    priority=int(rng.randint(0, 3)))))
            live.add(uid)
            uid += 1
        elif op == "abort" and live - finished:
            gone = min(live - finished)
            b.abort(gone)
            live.discard(gone)
        elif op == "squeeze":
            inj.hold_pages = 9
        elif op == "lift":
            inj.hold_pages = 0
        else:                   # a tick, or a submit/abort with no room
            finished |= {r.uid for r in b.step()}
        assert alloc_invariant(b.allocator), "pool accounting broken"
    inj.hold_pages = 0
    for _ in range(3000):
        finished |= {r.uid for r in b.step()}
        assert alloc_invariant(b.allocator), "pool accounting broken"
        if not b.queue and all(r is None for r in b.rows):
            break
    else:
        raise AssertionError("interleaving did not terminate")
    assert finished == live
