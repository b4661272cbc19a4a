"""Helpers of the serving parity tests (tests/test_torch_overload*.py,
tests/test_torch_tiering*.py, tests/test_torch_pool_report.py):
the smoke model in float32 in both packages (the reference's weights
bridged into the port), one interface over either package's serving
types, and the runner that holds the port's outcome of a protocol to the
reference's."""
import dataclasses

import jax
import numpy as np

from repro import serving as RS
from repro.configs import internlm2_1_8b as ref_cfgs
from repro.core import paging as RPG
from repro.models import transformer as RT
from repro_torch import serving as PS
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.core import paging as PG


def make_models():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


class Pkg:
    """One package's serving types behind one interface: ``ref`` True is
    the reference (`repro`), False the port (on the CPU)."""

    def __init__(self, models, ref: bool):
        (rcfg, rparams), (pcfg, pparams) = models
        self.ref = ref
        self.cfg, self.params = (rcfg, rparams) if ref else (pcfg, pparams)
        mod, pg = (RS, RPG) if ref else (PS, PG)
        self.Request, self.SamplingParams = mod.Request, mod.SamplingParams
        self.StallError = mod.StallError
        self.PoolExhaustedError = mod.PoolExhaustedError
        self.Injector = pg.PoolFaultInjector
        self._mod = mod

    def batcher(self, **config):
        cfg = self._mod.EngineConfig(**config)
        if self.ref:
            return self._mod.ContinuousBatcher(self.params, self.cfg, cfg)
        return self._mod.ContinuousBatcher(self.params, self.cfg, cfg,
                                           device="cpu")

    def engine(self, **config):
        cfg = self._mod.EngineConfig(**config)
        if self.ref:
            return self._mod.LLMEngine(self.params, self.cfg, cfg)
        return self._mod.LLMEngine(self.params, self.cfg, cfg, device="cpu")

    def prompts(self, sizes, seed=0):
        rng = np.random.RandomState(seed)
        return [rng.randint(0, self.cfg.vocab, (s,)).astype(np.int32)
                for s in sizes]


def alloc_invariant(a) -> bool:
    """free + ref + lru + deferred + inflight (promotions staging from the
    host tier) partition the allocatable pages."""
    pops = [set(a.free), set(a.ref), set(a.lru), set(a.deferred),
            set(a.inflight)]
    total = sum(len(p) for p in pops)
    return total == a.n_pages - 1 and len(set().union(*pops)) == total


def _comparable(report: dict) -> dict:
    """A pool report without its wall-clock TTFT percentiles."""
    return {k: v for k, v in report.items() if not k.startswith("ttft")}


def error_text(e: Exception) -> str:
    """An error's message, as the parity tests compare it (the stuck
    report's injector part, ``swap_faults=`` included, is the port's
    too)."""
    return str(e)


def run_both(models, protocol):
    """Run ``protocol(pkg)`` in both packages. It returns (outcome,
    reports): outcome is anything comparable (tokens, orders, error types
    and messages), reports a list of pool reports. The port must give the
    reference's outcome, and every report key the two share must agree
    (the wall-clock TTFT aside). Returns the port's (outcome, reports)."""
    (ro, rr), (po, pr) = [protocol(Pkg(models, ref))
                          for ref in (True, False)]
    assert po == ro, f"outcomes differ: reference {ro}, port {po}"
    assert len(pr) == len(rr)
    for a, b in zip(rr, pr):
        a, b = _comparable(a), _comparable(b)
        shared = set(a) & set(b)
        assert {k: b[k] for k in shared} == {k: a[k] for k in shared}
        for key in ("preemptions", "preempt_fast_resumes",
                    "preempt_recompute_resumes", "decode_stall_ticks",
                    "pages_deferred", "injected_alloc_fault_ticks",
                    "injected_delayed_releases", "injected_held_pages"):
            assert (key in a) == (key in b), key
    return po, pr


def grouped_run(pkg, host_pages, evictor="lru", host_tier_dtype=None,
                groups=3, rounds=2):
    """The tier protocols' workload (tests/test_tiering.py): ``groups``
    shared 24-token prefixes, each + 4 tokens, served one request at a
    time for ``rounds`` rounds through a pool of 9 pages too small to keep
    every group resident, so revisits promote from the host tier (or
    recompute without one). Returns (tokens by uid, batcher)."""
    b = pkg.batcher(batch=2, max_len=64, paged=True, n_pages=10, chunk=1,
                    prefix_cache=True, prefill_chunk=8, watermark=1,
                    host_pages=host_pages, evictor=evictor,
                    host_tier_dtype=host_tier_dtype)
    rng = np.random.RandomState(0)
    shared = [rng.randint(0, pkg.cfg.vocab, (24,)).astype(np.int32)
              for _ in range(groups)]
    outs, uid = {}, 0
    for _ in range(rounds):
        for g in shared:
            p = np.concatenate([g, rng.randint(0, pkg.cfg.vocab, (4,))
                                .astype(np.int32)])
            b.submit(pkg.Request(uid=uid, prompt=p, sampling=pkg
                                 .SamplingParams.greedy(max_new_tokens=4)))
            uid += 1
            for _t in range(300):
                for r in b.step():
                    outs[r.uid] = list(r.generated)
                if uid == len(outs):
                    break
            assert alloc_invariant(b.allocator)
    return outs, b
