"""The port's MoE (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`, no mesh: its `_apply_local`) on the same numpy inputs
and the reference's weights bridged through numpy.

- Routing: the top-k experts, the assignments' slots and which are kept
  equal the reference's routing (its `_route_row` lines, in JAX).
- ``apply``: out and aux within 1e-5 of their scale in float32, and out
  within one bf16 ulp of its scale in bfloat16 (the largest |out| of the
  reference: 2^-7 of its power of two; the SwiGLU's silu rounds once in
  the port and may round twice in the reference, and the output is
  rounded to bf16 last).

Cases: qwen2_moe smoke (dropless, capacity_factor 8), its weights at
capacity_factor 1.25 over a skewed 128-token row (assignments dropped),
a Mixtral-shaped MoE (4 experts, top-2, no shared experts) and S = 1, the
decode shape."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_moe_a2_7b as ref_cfgs
from repro.models import moe as RM
from repro_torch.configs import qwen2_moe_a2_7b as port_cfgs
from repro_torch.models import moe
from torch_parity import to_numpy, to_torch

jax.config.update("jax_platform_name", "cpu")

F32_RTOL = 1e-5
MIXTRAL = dict(n_experts=4, top_k=2, n_shared_experts=0, moe_d_ff=128,
               d_ff=128)
CASES = {  # name: (config changes, B, S, skewed input)
    "qwen2_moe_smoke": ({}, 2, 24, False),
    "qwen2_moe_cf1.25_drops": (dict(capacity_factor=1.25), 2, 128, True),
    "mixtral_shaped": (MIXTRAL, 2, 24, False),
    "decode_S1": ({}, 4, 1, False),
}


def _cfgs(changes, dtype):
    return (dataclasses.replace(ref_cfgs.smoke(), dtype=dtype, **changes),
            dataclasses.replace(port_cfgs.smoke(), dtype=dtype, **changes))


def _inputs(rcfg, B, S, skewed, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, rcfg.d_model).astype(np.float32)
    if skewed:      # every token of a row leans the same way: hot experts
        x += 1.5 * rng.randn(B, 1, rcfg.d_model).astype(np.float32)
    return x


def _ref_routing(p, xf, cfg, capacity):
    """The reference's `_route_row` up to its keep mask, for one row."""
    S = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.top_k)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    slot = jnp.cumsum(onehot, axis=0) - onehot
    flat_slot = jnp.take_along_axis(slot, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(top_e), np.asarray(flat_slot),
            np.asarray(flat_slot < capacity))


def _setup(changes, dtype, B, S, skewed):
    rcfg, pcfg = _cfgs(changes, dtype)
    rp = RM.init(rcfg, jax.random.PRNGKey(3))
    pp = jax.tree.map(lambda a: to_torch(np.asarray(a)), rp)
    x = _inputs(rcfg, B, S, skewed)
    rx = jnp.asarray(x).astype(rcfg.activation_dtype)
    px = torch.from_numpy(x).to(pcfg.activation_dtype)
    return rcfg, pcfg, rp, pp, rx, px


def _within(got, want, dtype):
    """max |got - want| within 1e-5 of the scale (float32) or one bf16 ulp
    of it (bfloat16); the scale is max |want|."""
    got, want = to_numpy(got).astype(np.float64), \
        to_numpy(want).astype(np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    tol = F32_RTOL * scale if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(scale)) - 7)
    assert err <= tol, (err, scale, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_reference(case):
    changes, B, S, skewed = CASES[case]
    rcfg, pcfg, rp, pp, rx, px = _setup(changes, "float32", B, S, skewed)
    C = moe.capacity(pcfg, S)
    assert C == int(max(8, round(rcfg.top_k * S / rcfg.n_experts
                                 * rcfg.capacity_factor)))
    r = moe.route(pp, px, pcfg, C)
    for b in range(B):
        top_e, slot, keep = _ref_routing(rp, rx[b], rcfg, C)
        np.testing.assert_array_equal(r["top_e"][b].numpy(), top_e)
        np.testing.assert_array_equal(r["slot"][b].numpy(), slot)
        np.testing.assert_array_equal(r["keep"][b].numpy(), keep)
    dropped = int((~r["keep"]).sum())
    assert (dropped > 0) == ("drops" in case), dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_reference(case, dtype):
    changes, B, S, skewed = CASES[case]
    rcfg, pcfg, rp, pp, rx, px = _setup(changes, dtype, B, S, skewed)
    rout, raux = RM.apply(rp, rx, rcfg)
    pout, paux = moe.apply(pp, px, pcfg)
    assert pout.dtype == pcfg.activation_dtype and pout.shape == px.shape
    _within(pout, np.asarray(rout), dtype)
    np.testing.assert_allclose(float(paux), float(raux), rtol=F32_RTOL)


def test_init_has_the_reference_leaves():
    """The port's own init draws the reference's leaves, shapes and
    dtypes (its numbers differ: the tests bridge the reference's)."""
    rcfg, pcfg = _cfgs({}, "bfloat16")
    rp = RM.init(rcfg, jax.random.PRNGKey(0))
    pp = moe.init(pcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t, f: {k: (shapes(v, f) if isinstance(v, dict) else f(v))
                           for k, v in t.items()}
    assert shapes(pp, lambda t: (tuple(t.shape), str(t.dtype)[6:])) == \
        shapes(rp, lambda a: (tuple(a.shape), str(a.dtype)))
