"""Training of the QKV-bias, MoE and M-RoPE families against the reference:
codeqwen1_5_7b, qwen2_5_32b (QKV bias), qwen2_moe_a2_7b (60-expert MoE
with shared experts, QKV bias), mixtral_8x22b (8-expert MoE, sliding
window) and qwen2_vl_2b (M-RoPE in text mode, QKV bias, GQA group 2 at
smoke size); smoke configs in float32, the reference's weights bridged
with QKV biases seeded non-zero (tests/torch_train_parity.py), sequence
32 (past mixtral's smoke window of 16, so it masks).

- `forward_train` (no remat) logits within 2e-5 of the reference's and
  the aux loss (the MoE's load balancing, summed over blocks) within
  1e-6 relative (measured 1.9e-6-2.7e-6 and equal on jax 0.9.0 and torch
  2.13.0 on the CPU).
- With ``embedding_inputs`` (qwen2_vl_2b's flag set in both packages),
  `forward_train` on (B, S, d) embeddings and `loss_fn` on
  ``batch["embeds"]`` against the reference's.
- One `make_train_step` step (remat) against the jitted reference's:
  loss, aux_loss, grad_norm and lr within 1e-5 relative; every
  parameter, m, v and master leaf within 1e-5 (|b| + max |b| of the
  leaf). The MoE steps run with the experts' capacity below the dropless
  smoke setting (qwen2_moe_a2_7b at capacity_factor 1.25 in 2
  microbatches, mixtral_8x22b at 1.0 in one), so assignments drop, as
  at full width: the test checks that some did.
- `compress_with_feedback` on identical numpy gradients in the MoE's
  layout (a one-channel leaf padded for the kernels): bitwise against the
  jitted reference's (tests/torch_train_parity.py).
- The train CLI `--smoke --device cpu` for 2 steps, finite losses.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro.models import transformer as RT
from repro.training import step as RS
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.training import step as S

ARCHS = ("codeqwen1_5_7b", "qwen2_5_32b", "qwen2_moe_a2_7b",
         "mixtral_8x22b", "qwen2_vl_2b")
B, SEQ = 4, 32
# (microbatches, capacity_factor) of the MoE steps: drops at capacity
MOE = {"qwen2_moe_a2_7b": (2, 1.25), "mixtral_8x22b": (1, 1.0)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    mods = P.models(arch)
    (rl, ra), (pl, pa) = P.forward_both(mods, P.batch(mods[0][0], B, SEQ))
    np.testing.assert_allclose(pl, rl, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(pa, ra, rtol=1e-6)
    assert (float(pa) > 0) == (arch in MOE)


def test_forward_train_takes_embeddings():
    """A config with ``embedding_inputs`` takes (B, S, d) embeddings in
    place of tokens, as the reference's `_embed` (qwen2_vl_2b's smoke
    config with its stub frontend's flag set in both packages); `loss_fn`
    reads them from ``batch["embeds"]``."""
    (rcfg, rp), (pcfg, pp) = P.models("qwen2_vl_2b", embedding_inputs=True)
    b = P.batch(rcfg, B, SEQ)
    b["embeds"] = np.random.RandomState(8).randn(
        B, SEQ, rcfg.d_model).astype(np.float32)
    rl, _ = RT.forward_train(rp, jnp.asarray(b["embeds"]), rcfg, remat=False)
    pl, _ = T.forward_train(pp, torch.from_numpy(b["embeds"]), pcfg,
                            remat=False)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(rl),
                               atol=2e-5, rtol=1e-5)
    rloss = RS.loss_fn(rp, {k: jnp.asarray(v) for k, v in b.items()}, rcfg)
    ploss = S.loss_fn(pp, {k: torch.from_numpy(v) for k, v in b.items()},
                      pcfg)
    np.testing.assert_allclose(float(ploss[0]), float(rloss[0]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_reference(arch, monkeypatch):
    mb, cf = MOE.get(arch, (1, None))
    mods = P.models(arch, **({"capacity_factor": cf} if cf else {}))
    kept = []
    route = moe.route

    def spy(p, x, cfg, C):
        r = route(p, x, cfg, C)
        kept.append(r["keep"].float().mean().item())
        return r
    monkeypatch.setattr(moe, "route", spy)
    ref, port = P.step_both(mods, P.batch(mods[0][0], B, SEQ), mb=mb)
    P.check_step(ref, port, mods[1][0])
    if arch in MOE:
        # every block, forward and recompute: some assignments dropped
        assert kept and min(kept) < 1.0, kept


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mixtral_8x22b"])
def test_compression_is_bitwise_in_the_reference_layout(arch):
    """The MoE's layout: stacked experts, the router, and qwen2_moe's
    shared-expert gate, a (d, 1) leaf whose one channel the kernels take
    padded to four."""
    (_, rparams), (pcfg, _) = P.models(arch)
    P.check_compression(rparams, pcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_two_steps(arch):
    seen = []
    assert train_cli.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", str(SEQ)],
        on_step=lambda i, m, s: seen.append((i, m))) == 0
    assert [i for i, _ in seen] == [0, 1]
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for _, m in seen)
    assert all((m["aux_loss"] > 0) == (arch in MOE) for _, m in seen)
