"""The RG-LRU block of the port (`repro_torch.models.rglru`) against the
reference's (`repro.models.rglru`) on the CPU, recurrentgemma_9b's smoke
widths (d 64, rnn width 64, conv width 4), the same parameters in both
(the gate vectors lam, w_a, b_a, w_x, b_x drawn per channel: init's
constants would hide a channel permutation) and the same numpy inputs:

- `apply_seq` (the log-depth scan of ``jax.lax.associative_scan``, the
  same combine order) without and with an initial state, over S = 37 (odd:
  the scan's ragged levels) and S = 64;
- `apply_step` without and with ``state_quant`` (the carried h through
  INT8, one scale a row), three steps from a prefilled state.

float32: outputs, final h and conv tail within |a - b| <= 1e-6 + 1e-5
|b| (measured ~1e-8: elementwise ops in another order). bfloat16 (the
config's dtype): outputs within 2^-7 of their largest magnitude (one
bf16 ulp: the reference rounds inside GeLU's bf16 arithmetic, the port
once, so about half the outputs land one ulp apart), h and the tail
within 1e-5 (float32 carries).

Also, as the reference's tests/test_models.py::test_rglru_scan_equals_step:
the port's scan equals its step recurrence (outputs within 0.05, h within
1e-3), in float32 to 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import rglru as RR
from repro_torch.configs import get_config
from repro_torch.models import rglru
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

ARCH = "recurrentgemma_9b"
F32_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_OUT_FRAC = 2.0 ** -7
STATE_TOL = dict(atol=1e-5, rtol=1e-5)


def _models(dtype: str, seed: int = 0):
    rcfg = dataclasses.replace(ref_get_config(ARCH, smoke=True), dtype=dtype)
    pcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    rp = RR.init(rcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    for name, (mean, std) in (("lam", (2.0, 0.5)), ("w_a", (0.5, 0.25)),
                              ("w_x", (0.5, 0.25)), ("b_a", (0.0, 0.25)),
                              ("b_x", (0.0, 0.25))):
        rp[name] = jnp.asarray((mean + std * rng.randn(
            rcfg.rnn_width)).astype(np.float32))
    pp = {k: to_torch(v) for k, v in rp.items()}
    assert pp["lam"].dtype == torch.float32
    assert pp["w_in"].dtype == pcfg.activation_dtype
    return (rcfg, rp), (pcfg, pp)


def _x(cfg, shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(cfg.dtype))


def _close_out(port, ref, dtype):
    p, r = to_numpy(port), to_numpy(ref)
    if dtype == "float32":
        np.testing.assert_allclose(p, r, **F32_TOL)
    else:
        assert np.abs(p - r).max() <= BF16_OUT_FRAC * np.abs(r).max()


def _close_state(port, ref, dtype):
    tol = F32_TOL if dtype == "float32" else STATE_TOL
    np.testing.assert_allclose(port.h.numpy(), np.asarray(ref.h), **tol)
    np.testing.assert_allclose(port.conv.numpy(), np.asarray(ref.conv),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "initial-state"])
def test_apply_seq_matches_reference(dtype, S, with_state):
    (rcfg, rp), (pcfg, pp) = _models(dtype)
    x = _x(rcfg, (2, S, rcfg.d_model), seed=S)
    rstate = pstate = None
    if with_state:
        # an initial state from a previous prompt piece
        x0 = _x(rcfg, (2, 11, rcfg.d_model), seed=99)
        _, rstate = RR.apply_seq(rp, x0, rcfg)
        _, pstate = rglru.apply_seq(pp, to_torch(x0), pcfg)
        _close_state(pstate, rstate, dtype)
    ro, rs = RR.apply_seq(rp, x, rcfg, rstate)
    po, ps = rglru.apply_seq(pp, to_torch(x), pcfg, pstate)
    assert po.dtype == pcfg.activation_dtype and po.shape == ro.shape
    _close_out(po, ro, dtype)
    _close_state(ps, rs, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_quant", [False, True],
                         ids=["fp-state", "int8-state"])
def test_apply_step_matches_reference(dtype, state_quant):
    (rcfg, rp), (pcfg, pp) = _models(dtype, seed=4)
    x = _x(rcfg, (3, 20, rcfg.d_model), seed=5)
    _, rs = RR.apply_seq(rp, x[:, :17], rcfg)
    _, ps = rglru.apply_seq(pp, to_torch(x[:, :17]), pcfg)
    for t in range(17, 20):
        ro, rs = RR.apply_step(rp, x[:, t:t + 1], rcfg, rs,
                               state_quant=state_quant)
        po, ps = rglru.apply_step(pp, to_torch(x[:, t:t + 1]), pcfg, ps,
                                  state_quant=state_quant)
        _close_out(po, ro, dtype)
        _close_state(ps, rs, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_equals_step(dtype):
    """The reference's own rule (tests/test_models.py): prefill's scan and
    the decode step's recurrence agree."""
    _, (pcfg, pp) = _models(dtype, seed=7)
    x = to_torch(_x(pcfg, (2, 12, pcfg.d_model), seed=8))
    out_seq, st_seq = rglru.apply_seq(pp, x, pcfg)
    st = rglru.init_state(pcfg, 2, "cpu")
    outs = []
    for t in range(12):
        o, st = rglru.apply_step(pp, x[:, t:t + 1], pcfg, st)
        outs.append(o)
    out_step = torch.cat(outs, dim=1)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=0.05, rtol=0.05))
    np.testing.assert_allclose(to_numpy(out_seq), to_numpy(out_step), **tol)
    np.testing.assert_allclose(st_seq.h.numpy(), st.h.numpy(),
                               **(tol if dtype == "float32"
                                  else dict(atol=1e-3, rtol=1e-3)))
    np.testing.assert_allclose(st_seq.conv.numpy(), st.conv.numpy(), **tol)
