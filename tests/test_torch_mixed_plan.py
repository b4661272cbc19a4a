"""Mixed per-layer KV precision plans on the port against the reference,
on the CPU (the smoke model in float32 with bridged weights, the
reference on its Pallas kernels in interpret mode; helpers in
tests/overload_parity.py):

- the resolver (`resolve_kv_dtype_spec`, `layer_kv_dtypes`,
  `PrecisionPlan`) over a table of specs: dtype strings, tuples and
  lists, both dict schemas, the committed PLAN_kv_mixed.json by path, a
  `to_json` round trip and bad inputs. Results, error types and messages
  identical;
- `EngineConfig` and `init_decode_state` take every plan form;
- the protocols of tests/test_mixed_precision_plan.py with
  PLAN2 = ("int8", "int4"): layer 0's pools in a mixed stack equal the
  uniform engine's byte for byte (and the reference's within the rule
  of tests/test_torch_prefix_cache.py: an int8 value one step off where
  the float32 K/V differ in their last bits), per-layer pool geometry and
  page bytes, an all-int8 plan serving the default engine's tokens and
  the submit contract under a plan.

The serving protocols are in tests/test_torch_mixed_plan_serve.py
(reports, flips, prefix cache), tests/test_torch_mixed_plan_stacks.py
(three dtypes in one stack), tests/test_torch_mixed_plan_committed.py
(the committed plan, the CLI), tests/test_torch_mixed_plan_tier.py and
tests/test_torch_mixed_plan_swap.py (the host tier on a plan).
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from overload_parity import Pkg, make_models, run_both
from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro_torch.core import paging as PG
from repro_torch.core import quantization as Q
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, make_chunk_prefill_fn
from test_mixed_precision_plan import _drive as ref_drive
from test_mixed_precision_plan import _layer_cache as ref_layer_cache
from torch_parity import pallas_interpret, to_numpy  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PLAN2 = ("int8", "int4")
PLAN_JSON = str(Path(__file__).resolve().parents[1] / "PLAN_kv_mixed.json")
INT8_STEP_FRAC = 5e-3        # tests/test_torch_prefix_cache.py's bound


@pytest.fixture(scope="module")
def models():
    return make_models()


def _outcome(fn):
    """What a call gives: ("ok", value) or (error type, message)."""
    try:
        v = fn()
    except Exception as e:                     # noqa: BLE001
        return type(e).__name__, str(e)
    if isinstance(v, (RQ.PrecisionPlan, Q.PrecisionPlan)):
        v = (v.layer_dtypes, v.ppl_budget_pct, v.measured_delta_pct,
             v.n_layers, v.is_uniform, v.to_json())
    return "ok", v


# -- the resolver -------------------------------------------------------------

def _specs(tmp):
    """(label, spec, n_layers) rows: every accepted form and bad input."""
    compact = tmp / "compact.json"
    compact.write_text(json.dumps({"layer_dtypes": ["int4", "fp8_e4m3"]}))
    uniform = tmp / "uniform.json"
    uniform.write_text(json.dumps({"layer_dtypes": ["int8"] * 4}))
    bad = tmp / "bad.json"
    bad.write_text(json.dumps({"layers": [{"layer": 0, "kv_dtype": "int8"},
                                          {"layer": 0, "kv_dtype": "int4"}]}))
    layers = [{"layer": 1, "kv_dtype": "int4"},
              {"layer": 0, "kv_dtype": "int8", "solo_delta_pct": 0.1}]
    rows = [(dt, dt, n) for dt in Q.KV_DTYPES for n in (None, 2)]
    rows += [
        ("tuple", PLAN2, 2), ("tuple any length", PLAN2, None),
        ("list", list(PLAN2), 2), ("three dtypes", Q.KV_DTYPES, 3),
        ("uniform tuple", ("int4", "int4"), 2),
        ("uniform list", ["int8"] * 3, None),
        ("one layer", ("fp8_e4m3",), 1),
        ("layer_dtypes dict", {"layer_dtypes": list(PLAN2)}, 2),
        ("layers dict, unsorted", {"layers": layers, "ppl_budget_pct": 1.0,
                                   "measured_delta_pct": 0.25}, 2),
        ("committed plan", PLAN_JSON, 4),
        ("committed plan, any length", PLAN_JSON, None),
        ("compact file", str(compact), 2), ("uniform file", str(uniform), 4),
        # bad inputs
        ("unknown dtype", "itn8", None), ("unknown dtype, n", "itn8", 2),
        ("unknown layer dtype", ("int8", "int3"), None),
        ("empty tuple", (), None), ("empty list", [], 2),
        ("wrong length", PLAN2, 4), ("committed plan, wrong length",
                                     PLAN_JSON, 2),
        ("layers twice", str(bad), None),
        ("layers skip", {"layers": [{"layer": 0, "kv_dtype": "int8"},
                                    {"layer": 2, "kv_dtype": "int4"}]}, None),
        ("dict without keys", {"dtypes": ["int8"]}, None),
        ("missing file", str(tmp / "missing.json"), None),
        ("a path that is not json", str(tmp / "plan"), None),
        ("int", 8, None), ("None", None, 2), ("float", 1.5, None),
    ]
    return rows


def _resolve(mod, spec, n):
    return (_outcome(lambda: mod.resolve_kv_dtype_spec(spec, n_layers=n)),
            _outcome(lambda: mod.layer_kv_dtypes(spec, n or 3)))


def test_resolver_matches_reference(tmp_path):
    """Every row of the table: the same resolved spec and per-layer
    dtypes, or the same error type and message, in both packages."""
    rows = _specs(tmp_path)
    for label, spec, n in rows:
        assert _resolve(Q, spec, n) == _resolve(RQ, spec, n), label
    got = {label: _resolve(Q, spec, n)[0] for label, spec, n in rows}
    assert got["tuple"] == ("ok", PLAN2)
    assert got["uniform list"] == ("ok", "int8")
    assert got["committed plan"] == ("ok", ("int4", "int8", "int4", "int4"))
    assert got["wrong length"][0] == "QuantizationError"
    assert got["layers twice"][0] == "QuantizationError"


def test_precision_plan_objects_match_reference(tmp_path):
    """`PrecisionPlan`: construction, `from_json` (both schemas),
    `to_json`, a `to_json` round trip through a file and `load`,
    `n_layers` and `is_uniform`, with the reference's values and errors."""
    def calls(mod):
        P = mod.PrecisionPlan
        plan = P(PLAN2, ppl_budget_pct=1.0, measured_delta_pct=0.01)
        path = tmp_path / f"{mod.__name__}.json"
        path.write_text(json.dumps(plan.to_json()))
        return [
            _outcome(lambda: plan),
            _outcome(lambda: P.from_json(plan.to_json())),
            _outcome(lambda: P.load(str(path))),
            _outcome(lambda: P.load(PLAN_JSON)),
            _outcome(lambda: P.from_json({"layer_dtypes": ["int8"] * 2})),
            _outcome(lambda: P(("int8", "int3"))),
            _outcome(lambda: P(())),
            _outcome(lambda: P.from_json(["int8"])),
            _outcome(lambda: P.from_json({"layers": [
                {"layer": 0, "kv_dtype": "int8"},
                {"layer": 2, "kv_dtype": "int4"}]})),
            _outcome(lambda: P.load(str(tmp_path / "missing.json"))),
        ]
    assert calls(Q) == calls(RQ)
    assert Q.PrecisionPlan.load(PLAN_JSON).measured_delta_pct == \
        json.loads(Path(PLAN_JSON).read_text())["measured_delta_pct"]


@pytest.mark.parametrize("form", ["tuple", "list", "plan", "compact dict",
                                  "layers dict", "path"])
def test_every_plan_form_reaches_config_and_state(tmp_path, form):
    """Each form of PLAN2 resolves in `EngineConfig` (paged; unpaged it
    raises the reference's error) and builds per-layer pools in
    `init_decode_state`."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(Q.PrecisionPlan(PLAN2).to_json()))
    spec = {"tuple": PLAN2, "list": list(PLAN2),
            "plan": Q.PrecisionPlan(PLAN2),
            "compact dict": {"layer_dtypes": list(PLAN2)},
            "layers dict": Q.PrecisionPlan(PLAN2).to_json(),
            "path": str(path)}[form]
    assert EngineConfig(paged=True, kv_cache_dtype=spec).kv_cache_dtype \
        == PLAN2
    ref_spec = RQ.PrecisionPlan(PLAN2) if form == "plan" else spec
    for paged in (False, True):
        got = _outcome(lambda: EngineConfig(paged=paged,
                                            kv_cache_dtype=spec)
                       .kv_cache_dtype)
        assert got == _outcome(lambda: RefEngineConfig(
            paged=paged, kv_cache_dtype=ref_spec).kv_cache_dtype)
    cfg = Pkg(make_models(), ref=False).cfg
    state = T.init_decode_state(cfg, 2, 64, paged=True, kv_cache_dtype=spec,
                                device="cpu")
    assert [c.pool.kv_dtype for c in state] == list(PLAN2)
    ref = RT.init_decode_state(cfg, 2, 64, paged=True, kv_cache_dtype=(
        RQ.PrecisionPlan(PLAN2) if form == "plan" else spec))
    assert [c.pool.kv_dtype for c in ref["p0"]] == list(PLAN2)


def test_bad_plans_raise_the_references_errors(models):
    """A plan of the wrong length fails `init_decode_state` (a mixed one
    also the batcher's construction), a bad dtype fails, a mixed plan
    fails unpaged `init_decode_state`: the reference's error types and
    messages."""
    (rcfg, rparams), (pcfg, pparams) = models
    got = []
    for spec in (("int8",) * 3, PLAN_JSON, ("int8", "int3")):
        got.append([
            _outcome(lambda: RT.init_decode_state(
                rcfg, 2, 64, paged=True, kv_cache_dtype=spec)),
            _outcome(lambda: T.init_decode_state(
                pcfg, 2, 64, paged=True, kv_cache_dtype=spec, device="cpu"))])
    got.append([
        _outcome(lambda: RT.init_decode_state(rcfg, 2, 64,
                                              kv_cache_dtype=PLAN2)),
        _outcome(lambda: T.init_decode_state(pcfg, 2, 64,
                                             kv_cache_dtype=PLAN2,
                                             device="cpu"))])
    got.append([_outcome(lambda: Pkg(models, ref).batcher(
        batch=2, max_len=64, paged=True, kv_cache_dtype=("int8", "int4") * 2))
        for ref in (True, False)])
    for ref, port in got:
        assert ref == port and ref[0] in ("ValueError", "QuantizationError")
    # EngineConfig knows no layer count: a uniform plan of the wrong length
    # collapses to its dtype there, and the batcher builds in both
    for ref in (True, False):
        b = Pkg(models, ref).batcher(batch=2, max_len=64, paged=True,
                                     kv_cache_dtype=("int8",) * 3)
        assert b.kv_cache_dtype == "int8"


# -- per-layer pools ----------------------------------------------------------

def _drive(cfg, params, spec, toks):
    """The reference test's `_drive` on the port: chunk prefill of
    ``toks`` over identity page tables, then two decode steps of fixed
    tokens (7, 8), so layer 0's inputs depend on the tokens only."""
    B, S = toks.shape
    state = T.init_decode_state(cfg, B, 64, paged=True, kv_cache_dtype=spec,
                                device="cpu")
    nt = 64 // cfg.quant.block_size
    tbl = (1 + torch.arange(B * nt, dtype=torch.int32)).reshape(B, nt)
    for c in state:
        c.page_table = tbl.clone()
    fn = make_chunk_prefill_fn(cfg, hist_blocks=4)
    rm = torch.ones((B,), dtype=torch.bool)
    toks = torch.as_tensor(toks, dtype=torch.int32)
    _, state = fn(params, toks, state, torch.zeros((B,), dtype=torch.int32),
                  torch.full((B,), S, dtype=torch.int32), rm)
    for i in range(2):
        tok = torch.full((B, 1), 7 + i, dtype=torch.int32)
        _, state = T.decode_step(params, tok, cfg, state,
                                 torch.full((B,), S + i, dtype=torch.int32),
                                 row_mask=rm)
    return state


def _values(q: np.ndarray, kv_dtype: str) -> np.ndarray:
    """Stored values as integers one quantization step apart: int8 as it
    is, int4 unpacked to its nibbles, fp8 codes as signed magnitudes (one
    step between neighbouring fp8 values of a sign)."""
    if kv_dtype == "int4":
        return to_numpy(Q.unpack_int4(torch.from_numpy(q.copy()))).astype(
            np.int32)
    q = q.astype(np.int32)
    if kv_dtype == "fp8_e4m3":
        mag = (q & 0x7F)
        return np.where(q < 0, -mag, mag)
    return q


def assert_pages_close(ref_pool, port_pool, kv_dtype, label=""):
    """The pools of one layer, the sentinel page aside: scales within
    1e-5 relative, values at most one step apart in at most
    INT8_STEP_FRAC of the places (tests/test_torch_prefix_cache.py)."""
    for name in ("k_q", "v_q", "k_s", "v_s"):
        x = to_numpy(getattr(ref_pool, name))[1:]
        y = to_numpy(getattr(port_pool, name))[1:]
        assert x.dtype == y.dtype and x.shape == y.shape, (label, name)
        if name.endswith("_s"):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=0,
                                       err_msg=f"{label} {name}")
            continue
        d = np.abs(_values(x, kv_dtype) - _values(y, kv_dtype))
        assert d.max() <= 1, (label, name)
        assert (d > 0).mean() <= INT8_STEP_FRAC, (label, name, d.mean())


@pytest.mark.parametrize("plan", [("int8", "int4"), ("int4", "int8")])
def test_first_layer_pools_bitwise_vs_uniform(pallas_interpret, models,
                                              plan):
    """Layer 0 sees the same inputs in a mixed and a uniform stack, so its
    pages, scales, residuals and length are byte for byte the uniform
    engine's, in the port as in the reference; every layer's pools agree
    with the reference's mixed run within the page rule."""
    (rcfg, rparams), (pcfg, pparams) = models
    toks = np.random.RandomState(5).randint(0, pcfg.vocab, (2, 16))
    mixed = _drive(pcfg, pparams, plan, toks)
    uni = _drive(pcfg, pparams, plan[0], toks)
    for name in ("k_q", "k_s", "v_q", "v_s"):
        a = to_numpy(getattr(mixed[0].pool, name))[1:]
        b = to_numpy(getattr(uni[0].pool, name))[1:]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("resid_k", "resid_v", "length"):
        assert torch.equal(getattr(mixed[0], name), getattr(uni[0], name))
    ref = ref_drive(rcfg, rparams, plan, jax.numpy.asarray(toks, np.int32))
    for layer, dt in enumerate(plan):
        assert_pages_close(ref_layer_cache(ref, layer).pool, mixed[layer].pool,
                           dt, f"layer {layer}")


def test_per_layer_pool_geometry(models):
    """Each layer's pool in a mixed stack has the storage dtype, shape and
    page bytes of a uniform pool of its dtype, as in the reference."""
    (rcfg, _), (pcfg, _) = models
    state = T.init_decode_state(pcfg, 2, 64, paged=True,
                                kv_cache_dtype=Q.KV_DTYPES[::-1][:2],
                                device="cpu")
    ref = RT.init_decode_state(rcfg, 2, 64, paged=True,
                               kv_cache_dtype=Q.KV_DTYPES[::-1][:2])
    for layer, dt in enumerate(Q.KV_DTYPES[::-1][:2]):
        c, r = state[layer], ref["p0"][layer]
        uni = T.init_decode_state(pcfg, 2, 64, paged=True, kv_cache_dtype=dt,
                                  device="cpu")[layer]
        ps = c.pool.page_size
        assert c.pool.kv_dtype == r.pool.kv_dtype == dt
        assert c.pool.k_q.dtype == uni.pool.k_q.dtype
        assert tuple(c.pool.k_q.shape) == tuple(uni.pool.k_q.shape) \
            == r.pool.k_q.shape
        assert to_numpy(c.pool.k_q).dtype == np.asarray(r.pool.k_q).view(
            np.int8 if dt == "fp8_e4m3" else r.pool.k_q.dtype).dtype
        assert c.pool.k_q.shape[1] == Q.packed_tokens(ps, dt)
        assert PG.page_bytes_for(ps, pcfg.n_kv_heads, pcfg.head_dim, dt) \
            == RPG.page_bytes_for(ps, rcfg.n_kv_heads, rcfg.head_dim, dt) \
            == sum(t.numel() * t.element_size() for t in (
                c.pool.k_q, c.pool.v_q, c.pool.k_s, c.pool.v_s)) \
            // c.pool.k_q.shape[0]


# -- serving ------------------------------------------------------------------

def _run_requests(pkg, b, uid0=0, n=2, max_new=5, **sampling):
    for i, p in enumerate(pkg.prompts([11] * n, seed=3)):
        b.submit(pkg.Request(uid=uid0 + i, prompt=p, sampling=pkg
                             .SamplingParams.greedy(max_new_tokens=max_new,
                                                    **sampling)))
    done = b.run_to_completion(max_ticks=400)
    assert len(done) == n
    return {r.uid - uid0: list(r.generated) for r in done}


def test_all_int8_plan_is_the_default_engine(pallas_interpret, models):
    """An all-int8 plan collapses to "int8": its engine gives the default
    engine's tokens and report, in both packages alike."""
    def proto(pkg):
        plan = pkg.batcher(batch=2, max_len=64, paged=True, prefill_chunk=8,
                           kv_cache_dtype=("int8", "int8"))
        default = pkg.batcher(batch=2, max_len=64, paged=True,
                              prefill_chunk=8)
        assert plan.kv_cache_dtype == "int8"
        return [_run_requests(pkg, plan), _run_requests(pkg, default)], \
            [plan.pool_report(), default.pool_report()]
    (plan, default), (rep, _) = run_both(models, proto)
    assert plan == default and rep["kv_cache_dtype"] == "int8"
    assert "kv_cache_layer_dtypes" not in rep


def test_submit_rejects_dtype_contradicting_plan(pallas_interpret, models):
    """Under a mixed plan a request naming any dtype, even one the plan
    uses, is rejected before any state changes, with the reference's
    message; kv_cache_dtype=None is served."""
    def proto(pkg):
        b = pkg.batcher(batch=2, max_len=64, paged=True, kv_cache_dtype=PLAN2)
        (p,) = pkg.prompts([11], seed=3)
        errors = []
        for dt in Q.KV_DTYPES:
            try:
                b.submit(pkg.Request(uid=0, prompt=p, sampling=pkg
                                     .SamplingParams.greedy(
                                         max_new_tokens=4,
                                         kv_cache_dtype=dt)))
            except ValueError as e:
                errors.append(str(e))
            assert not b.queue and not b._inflight_uids
        return [errors, _run_requests(pkg, b, uid0=1, n=1, max_new=4)], \
            [b.pool_report()]
    (errors, _), (rep,) = run_both(models, proto)
    assert len(errors) == 3 and all("plan" in e for e in errors)
    assert rep["kv_cache_dtype"] == "mixed"
