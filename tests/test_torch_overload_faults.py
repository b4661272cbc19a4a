"""Overload diagnostics and fault injection on the port's paged path
against the reference, on the CPU: the stall watchdog's `StallError`, the
preemption loop's `PoolExhaustedError`, `run_to_completion`'s stuck-state
`RuntimeError`, and recovery from transient allocation faults and from
delayed reclaim — the protocols of tests/test_overload.py, each run
through both packages (the smoke model in float32 with bridged weights,
the reference on its Pallas kernels in interpret mode): identical tokens,
`pool_report` counters, error types and messages (the stuck report's
``swap_faults=`` included)."""
import jax
import pytest

from overload_parity import alloc_invariant, error_text, make_models, run_both
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _raised(fn) -> tuple[str, str]:
    try:
        fn()
    except RuntimeError as e:
        return type(e).__name__, error_text(e)
    raise AssertionError("no error raised")


def test_stall_watchdog_raises_as_reference(pallas_interpret, models):
    """Permanent allocation faults starve admission: after ``stall_ticks``
    ticks without progress, `StallError` names the stuck uid and the
    injector's counters."""
    def proto(pkg):
        inj = pkg.Injector(seed=0, p_alloc_fail=1.0)
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=16,
                        chunk=1, stall_ticks=5, fault_injector=inj)
        (p0,) = pkg.prompts([9])
        b.submit(pkg.Request(uid=0, prompt=p0, sampling=pkg.SamplingParams
                             .greedy(max_new_tokens=4)))

        def spin():
            for _ in range(50):
                b.step()
        err = _raised(spin)
        return [err, b._watchdog.stalled_ticks, b.ticks], [b.pool_report()]
    ((name, msg), stalled, _), (rep,) = run_both(models, proto)
    assert name == "StallError" and "uid 0: queued" in msg
    assert stalled >= 5 and rep["injected_alloc_fault_ticks"] > 0


def test_pool_exhausted_lists_holders_as_reference(pallas_interpret, models):
    """Every row reaches its page boundary on one tick while the injector
    holds the whole pool: past ``preempt_loop_limit`` fruitless
    preemptions, `PoolExhaustedError` lists the page holders."""
    def proto(pkg):
        inj = pkg.Injector(seed=0)
        b = pkg.batcher(batch=3, max_len=64, paged=True, n_pages=12,
                        chunk=1, prefix_cache=True, watermark=0,
                        preempt_loop_limit=1, fault_injector=inj)
        ps = b.page_size
        for u, p in enumerate(pkg.prompts([ps, ps, ps])):
            b.submit(pkg.Request(uid=u, prompt=p, sampling=pkg
                                 .SamplingParams.greedy(max_new_tokens=10)))

        def spin():
            for _ in range(200):
                b.step()
                if not b.prefilling and all(r is not None for r in b.rows):
                    inj.hold_pages = b.n_pages - 1
        err = _raised(spin)
        return err, [b.pool_report()]
    (name, msg), (rep,) = run_both(models, proto)
    assert name == "PoolExhaustedError" and "page holders" in msg
    assert rep["preemptions"] >= 1


def test_run_to_completion_reports_stuck_state_as_reference(
        pallas_interpret, models):
    """With the watchdog disarmed, running out of ``max_ticks`` raises a
    RuntimeError that carries each stranded uid's state."""
    def proto(pkg):
        inj = pkg.Injector(seed=0, p_alloc_fail=1.0)
        b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=16,
                        chunk=1, stall_ticks=None, fault_injector=inj)
        (p0,) = pkg.prompts([9])
        b.submit(pkg.Request(uid=5, prompt=p0, sampling=pkg.SamplingParams
                             .greedy(max_new_tokens=4)))
        return _raised(lambda: b.run_to_completion(max_ticks=8)), \
            [b.pool_report()]
    (name, msg), _ = run_both(models, proto)
    assert name == "RuntimeError"
    assert "uids [5]" in msg and "uid 5: queued" in msg


def _drain_three(pkg, inj, **config):
    b = pkg.batcher(max_len=64, paged=True, chunk=1, fault_injector=inj,
                    **config)
    for u, p in enumerate(pkg.prompts([9, 11, 7])):
        b.submit(pkg.Request(uid=u, prompt=p, sampling=pkg.SamplingParams
                             .greedy(max_new_tokens=8)))
    done = b.run_to_completion(max_ticks=800)
    return {r.uid: r.generated for r in done}, b


def test_transient_alloc_faults_recover_as_reference(pallas_interpret,
                                                     models):
    """Seeded transient allocation faults only delay admission: the
    tokens equal a fault-free run's, and the faults fired."""
    def proto(pkg):
        config = dict(batch=2, n_pages=24, prefix_cache=True)
        clean, bc = _drain_three(pkg, None, **config)
        faulty, bf = _drain_three(pkg, pkg.Injector(seed=11,
                                                    p_alloc_fail=0.5),
                                  **config)
        return [clean, faulty, bc.ticks, bf.ticks], \
            [bc.pool_report(), bf.pool_report()]
    (clean, faulty, ticks_clean, ticks_faulty), (_, rep) = \
        run_both(models, proto)
    assert faulty == clean and ticks_faulty > ticks_clean
    assert rep["injected_alloc_fault_ticks"] > 0


def test_delayed_reclaim_recovers_as_reference(pallas_interpret, models):
    """Released pages park ``reclaim_delay`` ticks before reuse: timing
    changes, tokens do not, and the deferred population drains to 0."""
    def proto(pkg):
        config = dict(batch=1, n_pages=8)
        clean, bc = _drain_three(pkg, None, **config)
        inj = pkg.Injector(seed=3, reclaim_delay=3)
        delayed, b = _drain_three(pkg, inj, **config)
        rep = b.pool_report()
        for _ in range(4):
            b.allocator.tick()
        assert not b.allocator.deferred
        assert alloc_invariant(b.allocator)
        return [clean, delayed], [bc.pool_report(), rep]
    (clean, delayed), (_, rep) = run_both(models, proto)
    assert delayed == clean
    assert rep["injected_delayed_releases"] > 0
