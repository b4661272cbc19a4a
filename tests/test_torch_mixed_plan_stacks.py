"""Mixed per-layer KV precision plans in a deeper stack: the port against
the reference on the CPU (float32 smoke models with bridged weights, the
reference on its Pallas kernels in interpret mode; helpers in
tests/overload_parity.py, tests/test_torch_mixed_plan.py and
tests/test_torch_mixed_plan_serve.py). A 3-layer stack of ("int8",
"fp8_e4m3", "int4"), every format in one stack: identical tokens,
`pool_report` and `kv_cache_memory_report`, the pools against the
reference's within the page rule down to the first layer below an int4
or fp8 layer (`_check_pools` says why not past it). The committed plan
and the serve CLI: tests/test_torch_mixed_plan_committed.py.
"""
import dataclasses

import jax
import numpy as np

from overload_parity import run_both
from repro.configs import internlm2_1_8b as ref_cfgs
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from test_torch_mixed_plan import assert_pages_close
from test_torch_mixed_plan_serve import _layer_pools, _run_requests
from torch_parity import pallas_interpret, to_numpy  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PLAN3 = ("int8", "fp8_e4m3", "int4")


def _models(n_layers):
    """The float32 smoke model at ``n_layers`` in both packages, the
    reference's seeded weights bridged into the port."""
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32",
                               n_layers=n_layers)
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32",
                               n_layers=n_layers)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def _check_pools(batchers, plan) -> list[int]:
    """Each layer's pools of the two runs. A layer whose upstream layers
    all store int8 is held to the page rule. Below an int4 or fp8 layer
    it cannot hold: the K/V that the two packages quantize differ in
    their last float32 bits, so that layer's values land one step apart
    in a few places (the rule), and one step of int4 is 1/7 of the scale,
    of fp8 up to 1/8 of the value, against 1/127 for int8: the next
    layers' K/V then differ by far more than float rounding (measured:
    int8 values up to 3 steps apart, int4 scales 9.3e-4 relative). There
    the tokens are the gate and the pools must have been written in the
    same places (scale rows off their initial value). Returns the layers
    held to the rule."""
    rb, pb = batchers[True], batchers[False]
    ruled = []
    for layer, dt in enumerate(plan):
        ref, port = rb.state["p0"][layer].pool, pb.state[layer].pool
        if all(up == "int8" for up in plan[:layer]):
            assert_pages_close(ref, port, dt, f"layer {layer}")
            ruled.append(layer)
        for name in ("k_s", "v_s"):
            written = [to_numpy(getattr(pool, name))[1:] != np.float32(1e-30)
                       for pool in (ref, port)]
            assert np.array_equal(*written), (layer, name)
    return ruled


def check_stack(n_layers, spec) -> tuple:
    """Five prompts of mixed lengths on 2 rows with the prefix cache,
    through both packages at ``n_layers`` with ``spec``: identical tokens
    and reports (`run_both`), `kv_cache_memory_report` equal. Returns the
    port's report and the layers `_check_pools` held to the page rule."""
    models = _models(n_layers)
    batchers, mem = {}, {}

    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=128, paged=True, prefix_cache=True,
                        prefill_chunk=16, kv_cache_dtype=spec)
        out = _run_requests(pkg, b, sizes=(13, 70, 5, 40, 21),
                            max_new=6)
        batchers[pkg.ref] = b
        mem[pkg.ref] = pkg._mod.kv_cache_memory_report(
            b.cfg, batch=2, seq=128, paged_cache=_layer_pools(pkg, b))
        return out, [b.pool_report()]
    _, (rep,) = run_both(models, proto)
    plan = tuple(rep["kv_cache_layer_dtypes"])
    assert rep["kv_cache_dtype"] == "mixed" and len(plan) == n_layers
    assert mem[False] == mem[True]
    return rep, _check_pools(batchers, plan)


def test_three_dtype_stack_matches_reference(pallas_interpret):
    """Every page format in one stack (3 layers: int8, fp8_e4m3, int4):
    layers 0 and 1 within the page rule, layer 2 (below fp8) by place."""
    rep, ruled = check_stack(3, PLAN3)
    assert tuple(rep["kv_cache_layer_dtypes"]) == PLAN3 and ruled == [0, 1]
