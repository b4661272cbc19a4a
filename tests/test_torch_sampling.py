"""Seeded sampling of the port against the reference, on the CPU.

- `models.prng` against ``jax.random`` (jax 0.9, threefry partitionable):
  keys, `fold_in`, 32-bit bits and float32 uniforms bit for bit over
  several seeds (0, 1, 2**31-1, wrapping ones and a uid-derived seed);
  rejected seeds with the same error type; the committed known answers.
  Gumbel noise at (4, 92544) within GUMBEL_ATOL: XLA's CPU ``log`` is not
  torch's; 9.5e-7 measured on these inputs (23% of the elements differ).
- `_filter_logits` keep masks: equal except at the nucleus boundary,
  where the two libraries' softmax and cumsum sum in other orders; with
  these inputs that happens only in the float32-saturated tail of
  top_p = 1.0 rows (ROADMAP queue 3), and the disagreeing tokens' mass is
  bounded.
- `sample` / `sample_at_step` tokens identical; temperature 0 rows the
  exact argmax.
- The smoke model in float32 with bridged weights, the reference on its
  Pallas kernels in interpret mode: sampled `decode_scan`, `generate` and
  `LLMEngine` token streams (paged and contiguous) identical, solo and
  mid-batch, mirroring tests/test_sampling.py: batch-composition
  invariance, temperature 0 equals greedy, a chunked scan equals
  per-token ticks. `SamplingParams()` with its defaults serves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.models import sampling as RS
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import engine as RE
from repro.serving import params as RP
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.models import prng
from repro_torch.models import sampling as PS
from repro_torch.models import transformer as T
from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                 engine)
from repro_torch.serving import params as PP
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

V_FULL = 92544                   # internlm2_1_8b's vocabulary
GUMBEL_ATOL = 2e-6               # measured: 9.5e-7 (jax 0.9.0, torch 2.13)
BOUNDARY_TOL = 1e-6              # float64 mass before a disagreeing token


def _jkeys(keys_np):
    return jnp.asarray(np.asarray(keys_np, np.uint32))


def _tkeys(keys_np):
    return torch.from_numpy(np.asarray(keys_np, np.uint32).astype(np.int64))


def _key_of(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.uint32)


UID_SEED = int(RP.request_key(12345, RefSamplingParams(seed=None))[1])
SEEDS = [0, 1, 2**31 - 1, 2**31, 2**32 + 5, -7, 2**63 - 1, UID_SEED]


# -- prng ---------------------------------------------------------------------

def test_known_answers_match_jax():
    k = jax.random.PRNGKey(7)
    f = jax.random.fold_in(k, 3)
    assert tuple(np.asarray(k).tolist()) == prng.KNOWN_KEY_7
    assert tuple(np.asarray(f).tolist()) == prng.KNOWN_FOLD_7_3
    assert tuple(np.asarray(jax.random.bits(f, (4,))).tolist()) == \
        prng.KNOWN_BITS_7_3
    pk = prng.PRNGKey(7)
    pf = prng.fold_in(pk, 3)
    assert tuple(pk.tolist()) == prng.KNOWN_KEY_7
    assert tuple(pf.tolist()) == prng.KNOWN_FOLD_7_3
    assert tuple(prng.random_bits(pf, 4).tolist()) == prng.KNOWN_BITS_7_3


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_bits_uniform_bitwise(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _key_of(seed).astype(np.int64))
    assert np.array_equal(
        PP.request_key(3, SamplingParams(seed=seed)),
        RP.request_key(3, RefSamplingParams(seed=seed)))
    steps = np.asarray([0, 1, 47, 2**31 - 1], np.int32)
    base = np.stack([_key_of(seed)] * len(steps))
    ref = np.asarray(RS.fold_keys(_jkeys(base), jnp.asarray(steps)))
    port = PS.fold_keys(_tkeys(base), torch.from_numpy(steps))
    np.testing.assert_array_equal(port.numpy(), ref.astype(np.int64))
    V = 1031                              # odd: no pairing of counters
    rbits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (V,)))
                      for k in ref])
    np.testing.assert_array_equal(prng.random_bits(port, V).numpy(),
                                  rbits.astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        ru = np.stack([np.asarray(jax.random.uniform(
            jnp.asarray(k), (V,), minval=lo, maxval=1.0)) for k in ref])
        pu = prng.uniform(port, V, minval=lo).numpy()
        assert pu.dtype == np.float32 and pu.tobytes() == ru.tobytes()


def test_uid_derived_seed():
    """seed=None derives the key from the request uid, in both packages."""
    for uid in (0, 5, 2**31 + 9):
        sp = SamplingParams(seed=None)
        assert np.array_equal(PP.request_key(uid, sp),
                              RP.request_key(uid, RefSamplingParams()))
        assert np.array_equal(PP.request_key(uid, sp), _key_of(uid))


@pytest.mark.parametrize("seed", [2**63, 1.5, "3", None])
def test_rejected_seeds_raise_the_same_error(seed):
    with pytest.raises(Exception) as ref_err:
        jax.random.PRNGKey(seed)
    with pytest.raises(ref_err.type):
        prng.PRNGKey(seed)


def test_gumbel_within_tolerance_at_full_vocab():
    keys = np.stack([_key_of(s) for s in (0, 11, 12, 2**31 - 1)])
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V_FULL,)))(
        _jkeys(keys)))
    port = prng.gumbel(_tkeys(keys), V_FULL).numpy()
    assert port.shape == ref.shape == (4, V_FULL)
    err = np.abs(port - ref).max()
    assert err <= GUMBEL_ATOL, err


def test_categorical_matches_jax():
    rng = np.random.RandomState(5)
    keys = np.stack([_key_of(s) for s in range(6)])
    logits = (rng.randn(6, 4096) * 2).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.random.categorical)(
        _jkeys(keys), jnp.asarray(logits)))
    port = prng.categorical(_tkeys(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(port.numpy(), ref)


# -- the sampler --------------------------------------------------------------

def _sampler_inputs(trial, B=4, V=V_FULL):
    rng = np.random.RandomState(100 + trial)
    lg = (rng.randn(B, V) * 3).astype(np.float32)
    tk = rng.choice([0, 1, 40, 50, 1000], B).astype(np.int32)
    tp = rng.choice([1.0, 0.9, 0.95, 0.5, 1e-9], B).astype(np.float32)
    temp = rng.choice([0.0, 0.7, 1.0, 0.8, 1.3], B).astype(np.float32)
    keys = np.stack([_key_of(int(s)) for s in rng.randint(0, 2**31, B)])
    steps = rng.randint(0, 64, B).astype(np.int32)
    return lg, temp, tk, tp, keys, steps


def test_filter_logits_keep_masks_match():
    """Equal kept logits; a token kept by one package and dropped by the
    other must sit on the nucleus boundary: its float64 mass before it
    within BOUNDARY_TOL of top_p, and the disagreeing tokens' mass under
    BOUNDARY_TOL. On these inputs the masks disagree in one row of 48:
    the tail (1571 tokens, 1.03e-7 of the mass) of a top_p = 1.0 row,
    where the float32 cumsum saturates at 1.0 in one package and not in
    the other (ROADMAP queue 3)."""
    filt = jax.jit(RS._filter_logits)
    disagreeing_rows = 0
    for trial in range(12):
        lg, temp, tk, tp, _, _ = _sampler_inputs(trial)
        sc = lg / np.maximum(temp, 1e-6)[:, None]
        ref = np.asarray(filt(jnp.asarray(sc), jnp.asarray(tk),
                              jnp.asarray(tp)))
        port = PS._filter_logits(torch.from_numpy(sc), torch.from_numpy(tk),
                                 torch.from_numpy(tp)).numpy()
        for b in range(sc.shape[0]):
            kr, kp = ref[b] > -1e29, port[b] > -1e29
            both = kr & kp
            assert ref[b][both].tobytes() == port[b][both].tobytes()
            diff = kr != kp
            if not diff.any():
                continue
            disagreeing_rows += 1
            assert tp[b] == 1.0, (trial, b)     # as measured on these inputs
            k = int(tk[b]) if tk[b] > 0 else sc.shape[1]
            kth = np.sort(sc[b])[::-1][k - 1]
            x = np.where(sc[b] < kth, -np.inf, sc[b].astype(np.float64))
            pr = np.exp(x - x.max())
            pr /= pr.sum()
            order = np.argsort(-sc[b], kind="stable")
            before = np.empty_like(pr)
            before[order] = np.cumsum(pr[order]) - pr[order]
            assert np.abs(before[diff] - tp[b]).max() <= BOUNDARY_TOL, \
                (trial, b)
            assert pr[diff].sum() <= BOUNDARY_TOL, (trial, b)
    assert disagreeing_rows > 0        # the cumsum-order case is exercised


def test_sample_and_sample_at_step_tokens_identical():
    for trial in range(6):
        lg, temp, tk, tp, keys, steps = _sampler_inputs(trial)
        # 64 columns of head padding, which the vocab trims
        lgp = np.concatenate([lg, np.full((lg.shape[0], 64), 99.0,
                                          np.float32)], axis=1)
        args_r = (jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp))
        args_p = (torch.from_numpy(temp), torch.from_numpy(tk),
                  torch.from_numpy(tp))
        r1 = np.asarray(jax.jit(RS.sample, static_argnums=1)(
            jnp.asarray(lgp), V_FULL, *args_r, _jkeys(keys)))
        p1 = PS.sample(torch.from_numpy(lgp), V_FULL, *args_p, _tkeys(keys))
        np.testing.assert_array_equal(p1.numpy(), r1)
        r2 = np.asarray(jax.jit(RS.sample_at_step, static_argnames="vocab")(
            jnp.asarray(lgp), *args_r, _jkeys(keys), jnp.asarray(steps),
            vocab=V_FULL))
        p2 = PS.sample_at_step(torch.from_numpy(lgp), *args_p, _tkeys(keys),
                               torch.from_numpy(steps), vocab=V_FULL)
        np.testing.assert_array_equal(p2.numpy(), r2)
        assert p2.dtype == torch.int32
        greedy = temp <= 0
        np.testing.assert_array_equal(p2.numpy()[greedy],
                                      lg.argmax(-1)[greedy])


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


MIXED = [dict(temperature=0.7, top_k=50, seed=11),
         dict(temperature=0.0),
         dict(temperature=1.0, top_p=0.9, seed=12),
         dict(temperature=0.8, top_k=40, top_p=0.95, seed=None)]


def test_sampled_decode_scan_matches_reference(pallas_interpret, models):
    """The scan's sampled arm from a contiguous prefill: step j of row i
    draws with fold_in(key[i], step[i] + j)."""
    (rcfg, rparams), (pcfg, pparams) = models
    B, S, steps = 4, 16, 6
    prompts = np.random.RandomState(21).randint(
        0, rcfg.vocab, (B, S)).astype(np.int32)
    arrs = RP.sampling_arrays([RefSamplingParams(**kw) for kw in MIXED],
                              uids=[3, 4, 5, 6], steps=[2, 0, 5, 9])
    assert all(np.array_equal(arrs[k], v) for k, v in PP.sampling_arrays(
        [SamplingParams(**kw) for kw in MIXED], uids=[3, 4, 5, 6],
        steps=[2, 0, 5, 9]).items())

    rstate = RT.init_decode_state(rcfg, B, 32)
    rlog, rstate = RT.prefill(rparams, jnp.asarray(prompts), rcfg, rstate)
    tok0 = np.asarray(jnp.argmax(rlog[..., :rcfg.vocab], -1),
                      np.int32)[:, None]
    _, _, rtoks = jax.jit(lambda p, t, s, pos, sm: RT.decode_scan(
        p, t, rcfg, s, pos, steps=steps, sampling=sm))(
        rparams, jnp.asarray(tok0), rstate, jnp.full((B,), S, jnp.int32),
        {k: jnp.asarray(v) for k, v in arrs.items()})

    pstate = T.init_decode_state(pcfg, B, 32, device="cpu")
    _, pstate = T.prefill(pparams, torch.from_numpy(prompts), pcfg, pstate)
    _, _, ptoks = T.decode_scan(
        pparams, torch.tensor(tok0), pcfg, pstate,
        torch.full((B,), S, dtype=torch.int32), steps=steps,
        sampling=PS.device_arrays(arrs, "cpu"))
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(rtoks))
    assert not np.array_equal(ptoks.numpy()[:, 0], ptoks.numpy()[:, 1])


@pytest.mark.parametrize("S", [13, 5])
def test_sampled_generate_matches_reference(pallas_interpret, models, S):
    (rcfg, rparams), (pcfg, pparams) = models
    prompts = np.random.RandomState(S).randint(
        0, rcfg.vocab, (4, S)).astype(np.int32)
    ref = RE.generate(rparams, rcfg, jnp.asarray(prompts), steps=7,
                      sampling=[RefSamplingParams(**kw) for kw in MIXED])
    port = engine.generate(pparams, pcfg, prompts, steps=7,
                           sampling=[SamplingParams(**kw) for kw in MIXED],
                           device="cpu")
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    one = engine.generate(pparams, pcfg, prompts, steps=7, device="cpu",
                          sampling=SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(
        one.numpy(), engine.greedy_generate(pparams, pcfg, prompts, steps=7,
                                            device="cpu").numpy())
    np.testing.assert_array_equal(port.numpy()[1], one.numpy()[1])


SAMPLED = dict(temperature=0.9, top_p=0.85, top_k=12, seed=123,
               max_new_tokens=6)


def _engine_tokens(eng, sp_cls, prompts, sps, stagger=0):
    """Tokens of each request through an LLMEngine of either package;
    ``stagger`` submits the last request only after that many ticks, so it
    joins busy rows mid-stream."""
    outs, uids = {}, []
    head = len(prompts) - 1 if stagger else len(prompts)
    for p, kw in zip(prompts[:head], sps[:head]):
        uids.append(eng.add_request(p, sp_cls(**kw)))
    ticks = 0
    while eng.has_unfinished() or len(uids) < len(prompts):
        for o in eng.step():
            if o.finished:
                outs[o.uid] = o.token_ids
        ticks += 1
        if stagger and ticks == stagger and len(uids) < len(prompts):
            uids.append(eng.add_request(prompts[-1], sp_cls(**sps[-1])))
        assert ticks < 400
    return [outs[u] for u in uids]


def _both(models, prompts, sps, stagger=0, **config):
    (rcfg, rparams), (pcfg, pparams) = models
    ref = _engine_tokens(RefLLMEngine(rparams, rcfg,
                                      RefEngineConfig(**config)),
                         RefSamplingParams, prompts, sps, stagger)
    port = _engine_tokens(LLMEngine(pparams, pcfg, EngineConfig(**config),
                                    device="cpu"),
                          SamplingParams, prompts, sps, stagger)
    assert port == ref
    return port


def test_batch_composition_invariance_paged(pallas_interpret, models):
    """A seeded request gives the same tokens solo, in a mixed
    sampled/greedy batch and admitted mid-stream, in both packages."""
    rng = np.random.RandomState(11)
    target = rng.randint(0, 256, (6,)).astype(np.int32)
    others = [rng.randint(0, 256, (6,)).astype(np.int32) for _ in range(3)]
    solo = _both(models, [target], [SAMPLED], batch=1, max_len=64,
                 paged=True)[0]
    mixed = _both(models, others + [target],
                  [dict(temperature=0.0, max_new_tokens=5),
                   dict(temperature=1.1, seed=5, max_new_tokens=4),
                   dict(temperature=0.0, max_new_tokens=6), SAMPLED],
                  batch=2, max_len=64, paged=True)
    mid = _both(models, others[:2] + [target],
                [dict(temperature=0.0, max_new_tokens=6),
                 dict(temperature=0.0, max_new_tokens=8), SAMPLED],
                stagger=2, batch=2, max_len=64, paged=True, chunk=1)
    assert mixed[-1] == solo and mid[-1] == solo


def test_batch_composition_invariance_contiguous(pallas_interpret, models):
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, 256, (6,)).astype(np.int32) for _ in range(3)]
    solo = _both(models, prompts[:1], [SAMPLED], batch=1, max_len=64)[0]
    mixed = _both(models, prompts,
                  [SAMPLED, dict(temperature=0.0, max_new_tokens=6),
                   dict(temperature=1.3, seed=2, max_new_tokens=6)],
                  batch=3, max_len=64)
    assert mixed[0] == solo


def test_sampled_chunked_scan_matches_per_token(pallas_interpret, models):
    rng = np.random.RandomState(14)
    prompts = [rng.randint(0, 256, (6,)).astype(np.int32) for _ in range(3)]
    sps = [dict(temperature=0.8, top_p=0.9, seed=21, max_new_tokens=7),
           dict(temperature=0.0, max_new_tokens=4),
           dict(temperature=1.2, top_k=16, seed=22, max_new_tokens=6)]
    per_token = _both(models, prompts, sps, batch=2, max_len=64, paged=True,
                      chunk=1)
    chunked = _both(models, prompts, sps, batch=2, max_len=64, paged=True)
    assert chunked == per_token


def test_temperature_zero_equals_greedy_request(models):
    """SamplingParams(temperature=0) decodes what a default (greedy)
    Request decodes, on both backends; the port alone (greedy streams are
    held against the reference in tests/test_torch_serving.py)."""
    _, (pcfg, pparams) = models
    prompt = np.random.RandomState(13).randint(0, 256, (7,)).astype(np.int32)
    for paged in (False, True):
        runs = [LLMEngine(pparams, pcfg, EngineConfig(
            batch=1, max_len=64, paged=paged), device="cpu").generate(
            [prompt], sp)[0].token_ids
            for sp in (None, SamplingParams(temperature=0.0,
                                            max_new_tokens=16))]
        assert runs[0] == runs[1], f"paged={paged}"


@pytest.mark.parametrize("paged", [False, True])
def test_default_sampling_params_serve(pallas_interpret, models, paged):
    """`SamplingParams()` (temperature 1.0, seed from the uid) serves, and
    gives the reference's tokens."""
    rng = np.random.RandomState(15)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32) for n in (9, 14)]
    toks = _both(models, prompts, [{}, {}], batch=2, max_len=64,
                 paged=paged)
    assert [len(t) for t in toks] == [16, 16]
