"""The paged `pool_report`, `kv_cache_memory_report` and the live
`kv_cache_dtype` flip against the reference, on the CPU (the smoke model
in float32 with bridged weights, the reference on its Pallas kernels in
interpret mode; helpers in tests/overload_parity.py): the reference's key
set is contained in the port's with equal values, the capacity ratio of
int4 pages, the pool occupancy of one layer's cache, and the flip
protocols of tests/test_multi_precision.py (an idle flip serves what an
engine built on the new dtype serves; a flip with rows resident raises
and flipping back drains)."""
import dataclasses

import jax
import pytest

from overload_parity import Pkg, make_models, run_both
from repro.core import paging as RPG
from repro_torch.core import paging as PG
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


def _run_requests(pkg, b, uid0=0, n=2, max_new=5):
    for i, p in enumerate(pkg.prompts([11] * n, seed=3)):
        b.submit(pkg.Request(uid=uid0 + i, prompt=p, sampling=pkg
                             .SamplingParams.greedy(max_new_tokens=max_new)))
    done = b.run_to_completion(max_ticks=400)
    assert len(done) == n
    return {r.uid - uid0: list(r.generated) for r in done}


@pytest.mark.parametrize("config", [
    dict(),
    dict(prefix_cache=True, prefill_chunk=8),
    dict(kv_cache_dtype="int4", prefix_cache=True, watermark=1, n_pages=9,
         host_pages=8, evictor="freq"),
], ids=["paged", "prefix", "int4-tier-injector"])
def test_paged_report_contains_the_reference_keys(pallas_interpret, models,
                                                  config):
    """After serving, the port's report has every key of the reference's
    for the same uniform engine, and the values they share are equal."""
    keys = {}

    def proto(pkg):
        inj = pkg.Injector(seed=2) if "host_pages" in config else None
        b = pkg.batcher(batch=2, max_len=64, paged=True, chunk=1,
                        fault_injector=inj, **config)
        out = _run_requests(pkg, b, n=3)
        keys[pkg.ref] = set(b.pool_report())
        return out, [b.pool_report()]
    _, (rep,) = run_both(models, proto)
    assert keys[True] <= keys[False]
    cfg = Pkg(models, ref=False).cfg
    assert rep["device_bytes_live"] == rep["pages_live"] * cfg.n_layers * \
        PG.page_bytes_for(cfg.quant.block_size, cfg.n_kv_heads, cfg.head_dim,
                          rep["kv_cache_dtype"])


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3", "int4"])
def test_capacity_ratio_at_page_128(models, dtype):
    """`pages_vs_int8_equal_hbm` and the saved fraction at page 128 equal
    the reference's; int4 fits >= 1.9x the int8 pages at equal HBM."""
    reps = []
    for ref in (True, False):
        pkg = Pkg(models, ref)
        big = dataclasses.replace(pkg.cfg, quant=dataclasses.replace(
            pkg.cfg.quant, block_size=128))
        cfg = pkg._mod.EngineConfig(batch=2, max_len=256, paged=True,
                                    kv_cache_dtype=dtype)
        b = (pkg._mod.ContinuousBatcher(pkg.params, big, cfg) if ref else
             pkg._mod.ContinuousBatcher(pkg.params, big, cfg, device="cpu"))
        rep = b.pool_report()
        reps.append({k: rep[k] for k in (
            "kv_cache_dtype", "pages_vs_int8_equal_hbm",
            "kv_page_bytes_saved_vs_int8_frac", "device_bytes_live")})
    assert reps[0] == reps[1]
    ratio = reps[1]["pages_vs_int8_equal_hbm"]
    assert ratio >= 1.9 if dtype == "int4" else ratio == 1.0
    for hkv, d in ((2, 32), (8, 128)):
        assert PG.page_bytes_for(128, hkv, d, dtype) == \
            RPG.page_bytes_for(128, hkv, d, dtype)


def test_memory_report_of_one_layer_cache(pallas_interpret, models):
    """`kv_cache_memory_report(paged_cache=...)` after one tick of a
    request (prompt 6, budget 12): the reservation, the live pages, the
    page bytes and utilization equal the reference's."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True)
        (p,) = pkg.prompts([6])
        b.submit(pkg.Request(uid=0, prompt=p, max_new_tokens=12))
        b.step()
        cache = b.state["p0"] if pkg.ref else b.state[0]
        rep = pkg._mod.kv_cache_memory_report(b.cfg, batch=2, seq=64,
                                              paged_cache=cache)
        return rep, []
    rep, _ = run_both(models, proto)
    assert rep["pool_pages_allocated"] == -(-(8 + 12) // 8)
    assert rep["pool_pages_live"] == 2
    assert rep["pool_bytes_allocated"] == \
        rep["pool_pages_allocated"] * rep["pool_page_bytes"]


def test_idle_dtype_flip_serves_as_a_fresh_engine(pallas_interpret, models):
    """int8 -> fp8_e4m3 on an idle engine: the next requests give the
    tokens of an engine built on fp8_e4m3, and the rebuilt pools store
    fp8 pages, in both packages alike."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8)
        first = _run_requests(pkg, b)
        b.config.kv_cache_dtype = "fp8_e4m3"
        flipped = _run_requests(pkg, b, uid0=10)
        fresh = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8,
                            kv_cache_dtype="fp8_e4m3")
        return [first, flipped, _run_requests(pkg, fresh, uid0=10)], \
            [b.pool_report(), fresh.pool_report()]
    (_, flipped, fresh), (rep, _) = run_both(models, proto)
    assert flipped == fresh and rep["kv_cache_dtype"] == "fp8_e4m3"


def test_dtype_flip_with_resident_rows_raises(pallas_interpret, models):
    """A flip with a row resident raises the reference's RuntimeError; the
    flip back drains. On the contiguous backend any flip raises."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, chunk=1)
        (p,) = pkg.prompts([11], seed=3)
        b.submit(pkg.Request(uid=0, prompt=p, sampling=pkg.SamplingParams
                             .greedy(max_new_tokens=8)))
        b.step()
        b.step()
        b.config.kv_cache_dtype = "int4"
        errors = []
        for _ in range(2):
            try:
                b.step()
            except RuntimeError as e:
                errors.append((type(e).__name__, str(e)))
        b.config.kv_cache_dtype = "int8"
        done = b.run_to_completion(max_ticks=400)
        c = pkg.batcher(batch=2, max_len=64)
        c.config.kv_cache_dtype = "int4"
        try:
            c.step()
        except RuntimeError as e:
            errors.append((type(e).__name__, str(e)))
        return [errors, [list(r.generated) for r in done]], \
            [b.pool_report()]
    (errors, done), _ = run_both(models, proto)
    assert len(errors) == 3 and "resident" in errors[0][1]
    assert "paged backend" in errors[2][1] and len(done[0]) == 8


def test_serve_cli_reports_capacity_and_tier(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "internlm2_1_8b", "--smoke", "--batch", "2",
                       "--max-len", "64", "--requests", "5",
                       "--prompt-len", "20", "--shared-prefix", "16",
                       "--prefill-chunk", "8", "--max-new", "4",
                       "--pages", "8", "--host-pages", "16",
                       "--evictor", "freq", "--host-tier-dtype", "int4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1.00x pages vs int8 at equal HBM" in out
    assert "host tier (freq evictor, dtype=int4)" in out
    assert "prefix cache: hit rate" in out
