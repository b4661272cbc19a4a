"""The port's qwen2_vl_2b (the text-mode language model: M-RoPE sections
over GQA 12 / 2 at full width, QKV bias) against the reference, smoke,
float32, QKV biases seeded non-zero in both trees (tests/torch_arch.py),
the reference on its Pallas kernels in interpret mode:

- `apply_mrope` against the reference's on text and on mixed (temporal,
  height, width) positions: `rope_freqs` and the angles bit for bit (a
  position times a frequency, one float32 product a channel; the port
  takes the power in float64 and rounds once, as the reference's
  correctly rounded float32 power), the rotated values within
  atol 2e-6 (torch's and XLA's float32 sin / cos differ in the last bits;
  measured 4.8e-7 on jax 0.9.0 and torch 2.13.0 on the CPU);
  `text_mrope_positions` equal; in text mode `apply_mrope` is
  `apply_rope` bit for bit in each package (tests/test_models.py's
  identity);
- the bridge keeps every weight; `forward_train` gives the reference's
  ``forward_train`` logits within 2e-5 (with and without remat;
  tests/test_torch_train_families.py holds its train step);
- paged chunk prefill, contiguous prefill and a decode step each within
  atol 2e-3 (tests/test_torch_arch_forward.py's protocol), the pages
  within the page rule; the memory report and the serve CLI on both
  backends. tests/test_torch_vlm_serve.py holds `LLMEngine`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import common as RC
from repro.models import transformer as RT
from repro.serving import engine as RE
from repro_torch.configs import get_config
from repro_torch.models import common as PC
from repro_torch.models import transformer as T
from repro_torch.serving import kv_cache_memory_report
from test_torch_arch_forward import (
    test_bridge_keeps_every_weight as bridge_case,
    test_contiguous_prefill_and_decode_match as contiguous_case,
    test_paged_prefill_and_decode_match as paged_case)
from torch_arch import smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen2_vl_2b"
ROT_ATOL = 2e-6


def _rope_inputs(seed, B=2, H=3, S=40, D=16, mixed=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, S, D).astype(np.float32)
    if mixed:       # a patch grid: rows of its own per section
        pos = rng.randint(0, 5000, (B, 3, S)).astype(np.int32)
    else:
        pos = np.broadcast_to(rng.randint(0, 5000, (B, 1, S)),
                              (B, 3, S)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 10000.0),
                                            ((16, 24, 24), 1e6)],
                         ids=["smoke", "full"])
@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "text"])
def test_mrope_matches_reference(sections, theta, mixed):
    D = 2 * sum(sections)
    x, pos = _rope_inputs(3, D=D, mixed=mixed)
    want = np.asarray(RC.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                     sections, theta))
    got = PC.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                         sections, theta).numpy()
    np.testing.assert_allclose(got, want, atol=ROT_ATOL, rtol=0)
    # the angles: the reference's einsum("bft,f->btf") is one product a
    # channel, the port's the same product
    freqs = np.array(RC.rope_freqs(D, theta))
    np.testing.assert_array_equal(
        PC.rope_freqs(D, theta, "cpu").numpy(), freqs)
    sec = np.repeat(np.arange(3), sections)
    ref_ang = np.asarray(jnp.einsum(
        "bft,f->btf", jnp.asarray(pos.astype(np.float32))[:, sec], freqs))
    port_ang = (torch.from_numpy(pos).float()[:, torch.from_numpy(sec)]
                .transpose(1, 2) * torch.from_numpy(freqs)).numpy()
    np.testing.assert_array_equal(port_ang, ref_ang)


def test_text_mrope_equals_rope_and_positions_match():
    x, pos = _rope_inputs(4, D=16, mixed=False)
    pos2 = pos[:, 0]
    np.testing.assert_array_equal(
        PC.text_mrope_positions(torch.from_numpy(pos2)).numpy(),
        np.asarray(RC.text_mrope_positions(jnp.asarray(pos2))))
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos2)
    for dt in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            PC.apply_mrope(tx.to(dt), PC.text_mrope_positions(tp), (2, 3, 3),
                           1e6).float().numpy(),
            PC.apply_rope(tx.to(dt), tp, 1e6).float().numpy())
    # the reference's own identity (tests/test_models.py)
    np.testing.assert_array_equal(
        np.asarray(RC.apply_mrope(jnp.asarray(x), RC.text_mrope_positions(
            jnp.asarray(pos2)), (2, 3, 3), 1e6)),
        np.asarray(RC.apply_rope(jnp.asarray(x), jnp.asarray(pos2), 1e6)))
    with pytest.raises(ValueError, match="sum to head_dim / 2"):
        PC.apply_mrope(tx, PC.text_mrope_positions(tp), (2, 3, 2))


def test_bridge_keeps_every_weight():
    bridge_case(ARCH)


def test_forward_matches_reference():
    (rcfg, rp), (pcfg, pp) = smoke_models(ARCH)
    toks = np.random.RandomState(6).randint(0, rcfg.vocab, (2, 24))
    rl, _ = RT.forward_train(rp, jnp.asarray(toks, jnp.int32), rcfg,
                             remat=False)
    for remat in (False, True):
        pl, _ = T.forward_train(pp, torch.from_numpy(toks), pcfg,
                                remat=remat)
        np.testing.assert_allclose(pl.detach().numpy(), np.asarray(rl),
                                   atol=2e-5)


def test_paged_prefill_and_decode_match(pallas_interpret):
    paged_case(pallas_interpret, ARCH)


def test_contiguous_prefill_and_decode_match(pallas_interpret):
    contiguous_case(pallas_interpret, ARCH)


def test_memory_report_matches_reference():
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    for batch, seq in ((128, 32_768), (4, 2048)):
        assert kv_cache_memory_report(cfg, batch, seq) == \
            RE.kv_cache_memory_report(rcfg, batch, seq)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_serve_cli_serves(paged, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--batch", "2",
                       "--max-len", "64", "--requests", "3", "--prompt-len",
                       "13", "--max-new", "4", "--device", "cpu"]
                      + ["--paged"] * paged) == 0
    assert "completed 3/3 requests" in capsys.readouterr().out
