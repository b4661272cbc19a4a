"""The xLSTM blocks of the port (`repro_torch.models.xlstm`) against the
reference's (`repro.models.xlstm`) on the CPU, xlstm_350m's smoke widths
(d 64, 4 heads of 16), the same parameters and numpy inputs in both:

- `mlstm_seq`, the chunkwise-parallel form, at one chunk (chunk = S = 32)
  and at several (chunk 8: the chunk-end update under a new running max
  carries the state), its outputs and final (C, n, m); a sequence that is
  no chunk multiple raises, as the reference asserts;
- `mlstm_step` from a prefilled state, three steps, without and with
  ``state_quant`` (the matrix memory stored INT8 with per-channel scales
  between steps: the int8 C within one step and its scales within 1e-6
  relative, as one rounding may land on the other side of a .5);
- `slstm_seq` (a true recurrence, one token at a time) and `slstm_step`.

float32: outputs and states within |a - b| <= 2e-5 + 1e-4 |b| (measured
up to 2e-6 on mLSTM outputs of ~1: sums over a chunk in another order).
bfloat16 (the config's dtype): outputs within 2^-7 of their largest
magnitude (one bf16 ulp: the sLSTM's carried h is rounded to bf16 before
its recurrent product, so a last-bit difference feeds back), the float32
states within 2e-2 of their largest magnitude.

Also, as the reference's
tests/test_models.py::test_mlstm_chunked_equals_step_recurrence: the
port's chunked mLSTM equals its step recurrence (outputs within 0.05, the
stabilized C * e^m within 1e-3), and its sLSTM sequence equals its steps
within 1e-6 (the sequence projects every token's input in one matmul)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import xlstm as RX
from repro_torch.configs import get_config
from repro_torch.models import xlstm
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm_350m"
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_OUT_FRAC = 2.0 ** -7
BF16_STATE_FRAC = 2e-2


def _models(dtype: str, init, seed: int):
    rcfg = dataclasses.replace(ref_get_config(ARCH, smoke=True), dtype=dtype)
    pcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    rp = getattr(RX, init)(rcfg, jax.random.PRNGKey(seed))
    pp = {k: to_torch(v) for k, v in rp.items()}
    return (rcfg, rp), (pcfg, pp)


def _x(cfg, shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(cfg.dtype))


def _close(port, ref, dtype, frac=BF16_OUT_FRAC):
    p, r = to_numpy(port).astype(np.float32), to_numpy(ref).astype(
        np.float32)
    assert p.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(p, r, **F32_TOL)
    else:
        assert np.abs(p - r).max() <= frac * max(np.abs(r).max(), 1e-30)


def _close_states(ps, rs, names, dtype):
    for n in names:
        _close(getattr(ps, n), getattr(rs, n), dtype, BF16_STATE_FRAC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 8], ids=["one-chunk", "4-chunks"])
def test_mlstm_seq_matches_reference(dtype, chunk):
    (rcfg, rp), (pcfg, pp) = _models(dtype, "mlstm_init", seed=1)
    x = _x(rcfg, (2, 32, rcfg.d_model), seed=chunk)
    ro, rs = RX.mlstm_seq(rp, x, rcfg, chunk=chunk)
    po, ps = xlstm.mlstm_seq(pp, to_torch(x), pcfg, chunk=chunk)
    assert po.dtype == pcfg.activation_dtype
    _close(po, ro, dtype)
    _close_states(ps, rs, ("C", "n", "m", "C_s"), dtype)
    with pytest.raises(ValueError, match="multiple"):
        xlstm.mlstm_seq(pp, to_torch(x[:, :12]), pcfg, chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_quant", [False, True],
                         ids=["fp-state", "int8-state"])
def test_mlstm_step_matches_reference(dtype, state_quant):
    (rcfg, rp), (pcfg, pp) = _models(dtype, "mlstm_init", seed=2)
    x = _x(rcfg, (3, 19, rcfg.d_model), seed=3)
    if state_quant:      # from the INT8 initial state
        rs = RX.mlstm_init_state(rcfg, 3, state_quant=True)
        ps = xlstm.mlstm_init_state(pcfg, 3, state_quant=True, device="cpu")
        assert ps.C.dtype == torch.int8
        t0 = 0
    else:                # from a prefilled state
        _, rs = RX.mlstm_seq(rp, x[:, :16], rcfg, chunk=8)
        _, ps = xlstm.mlstm_seq(pp, to_torch(x[:, :16]), pcfg, chunk=8)
        t0 = 16
    for t in range(t0, t0 + 3):
        ro, rs = RX.mlstm_step(rp, x[:, t:t + 1], rcfg, rs,
                               state_quant=state_quant)
        po, ps = xlstm.mlstm_step(pp, to_torch(x[:, t:t + 1]), pcfg, ps,
                                  state_quant=state_quant)
        _close(po, ro, dtype)
        _close_states(ps, rs, ("n", "m"), dtype)
        if state_quant:
            rc = np.asarray(rs.C).astype(np.int32)
            assert ps.C.dtype == torch.int8
            assert np.abs(ps.C.numpy().astype(np.int32) - rc).max() <= 1
            np.testing.assert_allclose(ps.C_s.numpy(), np.asarray(rs.C_s),
                                       rtol=1e-6 if dtype == "float32"
                                       else BF16_STATE_FRAC)
        else:
            _close_states(ps, rs, ("C",), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_matches_reference(dtype):
    (rcfg, rp), (pcfg, pp) = _models(dtype, "slstm_init", seed=4)
    rp["b"] = jnp.asarray(np.random.RandomState(6).randn(
        4 * rcfg.d_model).astype(np.float32) * 0.5)   # init draws zeros
    pp["b"] = to_torch(rp["b"])
    x = _x(rcfg, (2, 21, rcfg.d_model), seed=5)
    ro, rs = RX.slstm_seq(rp, x[:, :18], rcfg)
    po, ps = xlstm.slstm_seq(pp, to_torch(x[:, :18]), pcfg)
    _close(po, ro, dtype)
    _close_states(ps, rs, ("c", "n", "h", "m"), dtype)
    for t in range(18, 21):
        ro, rs = RX.slstm_step(rp, x[:, t:t + 1], rcfg, rs)
        po, ps = xlstm.slstm_step(pp, to_torch(x[:, t:t + 1]), pcfg, ps)
        _close(po, ro, dtype)
        _close_states(ps, rs, ("c", "n", "h", "m"), dtype)


def test_mlstm_chunked_equals_step_recurrence():
    """The reference's own rule (tests/test_models.py), on the port."""
    _, (pcfg, pp) = _models("bfloat16", "mlstm_init", seed=5)
    x = to_torch(_x(pcfg, (2, 16, pcfg.d_model), seed=6))
    out_seq, st_seq = xlstm.mlstm_seq(pp, x, pcfg, chunk=8)
    st = xlstm.mlstm_init_state(pcfg, 2, device="cpu")
    outs = []
    for t in range(16):
        o, st = xlstm.mlstm_step(pp, x[:, t:t + 1], pcfg, st)
        outs.append(o)
    np.testing.assert_allclose(to_numpy(out_seq),
                               to_numpy(torch.cat(outs, dim=1)),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(
        (st_seq.C * torch.exp(st_seq.m)[..., None, None]).numpy(),
        (st.C * torch.exp(st.m)[..., None, None]).numpy(),
        rtol=1e-3, atol=1e-3)


def test_slstm_sequence_equals_its_steps():
    _, (pcfg, pp) = _models("float32", "slstm_init", seed=7)
    x = to_torch(_x(pcfg, (2, 9, pcfg.d_model), seed=8))
    out_seq, st_seq = xlstm.slstm_seq(pp, x, pcfg)
    st = xlstm.slstm_init_state(pcfg, 2, device="cpu")
    outs = []
    for t in range(9):
        o, st = xlstm.slstm_step(pp, x[:, t:t + 1], pcfg, st)
        outs.append(o)
    np.testing.assert_allclose(out_seq.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(st_seq.c.numpy(), st.c.numpy(), atol=1e-6,
                               rtol=1e-6)
