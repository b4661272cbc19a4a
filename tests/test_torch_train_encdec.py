"""Training of whisper_small (the encoder-decoder, `models/encdec.py`)
against the reference, and the flash attention backward at every shape
the families train; smoke config in float32, the reference's weights
bridged, frames from `make_frames` (tests/torch_train_parity.py).

- `forward_train` (no remat) logits within 2e-5, aux 0.
- One `make_train_step` step (the encdec branch of `loss_fn`: frames and
  tokens; the tied embedding's gradient from the input gather and the
  head) against the jitted reference's under tests/test_torch_train.py's
  rule, without and with ``grad_compression`` (the error state in the
  reference's ``enc_blocks`` / ``dec_blocks`` layout; at most 1e-4 of
  the elements a level apart, the error state within 1e-5 of its leaf's
  largest gradient), and with ``microbatches=2`` (the split slices the
  frames too).
- `compress_with_feedback` on identical numpy gradients: bitwise against
  the jitted reference's, the error state bitwise (g + e) - compressed.
- The train CLI `--smoke --device cpu`: 2 steps with a checkpoint, then
  a resume to step 3 (the encoder-decoder tree saved and restored).
- `models.flash.flash_attention`'s backward (the plain `_flash_bwd`)
  against `jax.grad` through the reference's custom_vjp, float32, head
  width 16: causal with a window of 16 over S 48 (several kv blocks, the
  last one padded), non-causal self-attention (the encoder), non-causal
  S 16 over T 24 (cross-attention), GQA groups 1, 3, 6 and 16; dq, dk and
  dv within 1e-5 (|b| + max |b|). Head widths 64, 128 and 256 run in the
  `gpu` tests (tests/test_torch_gpu.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro.models import flash as RF
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as train_cli
from repro_torch.models import flash
from torch_parity import to_torch

ARCH = "whisper_small"
B, SEQ = 4, 16


def test_forward_train_matches_reference():
    mods = P.models(ARCH)
    (rl, ra), (pl, pa) = P.forward_both(mods, P.batch(mods[0][0], B, SEQ))
    np.testing.assert_allclose(pl, rl, atol=2e-5, rtol=1e-5)
    assert float(pa) == float(ra) == 0.0


@pytest.mark.parametrize("mb,gc", [(1, False), (1, True), (2, False)],
                         ids=["plain", "compressed", "microbatches2"])
def test_train_step_matches_jitted_reference(mb, gc):
    mods = P.models(ARCH)
    ref, port = P.step_both(mods, P.batch(mods[0][0], B, SEQ), mb=mb, gc=gc)
    P.check_step(ref, port, mods[1][0], gc=gc)


def test_compression_is_bitwise_in_the_reference_layout():
    (_, rparams), (pcfg, _) = P.models(ARCH)
    P.check_compression(rparams, pcfg)


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", str(SEQ), "--ckpt-dir", str(tmp_path),
            "--grad-compression"]
    seen = []
    assert train_cli.main(argv, on_step=lambda i, m, s: seen.append(
        (i, m))) == 0
    assert [i for i, _ in seen] == [0, 1]
    assert all(math.isfinite(m["loss"]) for _, m in seen)
    assert latest_step(str(tmp_path)) == 2
    capsys.readouterr()
    argv[argv.index("--steps") + 1] = "3"
    assert train_cli.main(argv, on_step=lambda i, m, s: seen.append(
        (i, m))) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    assert [i for i, _ in seen] == [0, 1, 2]
    assert latest_step(str(tmp_path)) == 3


# (H, H_kv, S, T, causal, window, kv_block)
FLASH_CASES = {
    "causal_window": (4, 4, 48, 48, True, 16, 20),
    "encoder_noncausal": (4, 4, 24, 24, False, None, 512),
    "cross_s16_t24": (4, 4, 16, 24, False, None, 16),
    "gqa3": (6, 2, 32, 32, True, None, 512),
    "gqa6": (12, 2, 32, 32, True, None, 512),
    "gqa16_window": (16, 1, 40, 40, True, 16, 16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_jax_grad(case):
    H, Hkv, S_, T, causal, window, kv_block = FLASH_CASES[case]
    D = 16
    rng = np.random.RandomState(sorted(FLASH_CASES).index(case))
    q, k, v, w = (rng.randn(*s).astype(np.float32) for s in (
        (2, H, S_, D), (2, Hkv, T, D), (2, Hkv, T, D), (2, H, S_, D)))
    kv_offset = T - S_ if causal else 0

    def ref_loss(a, b, c):
        return jnp.sum(RF.flash_attention(a, b, c, causal, window, kv_offset,
                                          kv_block) * w)
    ref = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(q, k, v)
    pq, pk, pv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    out = flash.flash_attention(pq, pk, pv, causal, window, kv_offset,
                                kv_block)
    port = torch.autograd.grad((out * to_torch(w)).sum(), [pq, pk, pv])
    P.close_trees([g.numpy() for g in port],
                  [np.asarray(g) for g in ref], P.RTOL)
