"""The prefill and decode logits of the port's recurrent and sliding-window
models (recurrentgemma_9b, xlstm_350m, mixtral_8x22b; smoke, float32, the
reference's weights bridged, RG-LRU gate vectors seeded per channel:
tests/torch_arch.py) against the reference's on the contiguous cache, the
reference on its Pallas kernels in interpret mode: a 24-token prefill
(longer than the smoke window of 16: the ring wraps) and 8 decode steps
(the last flushes a block) give the reference's logits within atol 2e-3
(an int8 value one step apart moves them, as in
tests/test_torch_arch_forward.py; the recurrences alone agree to ~1e-6,
tests/test_torch_rglru.py and tests/test_torch_xlstm.py), and the decode
logits stay within 0.35 of the teacher-forced logits' scale (the rule of
the reference's tests/test_models.py), the teacher being the reference's
`forward_train` on the same weights. Every tensor of the decode state
keeps its address (updated in place)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.models import transformer as T
from torch_arch import smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("recurrentgemma_9b", "xlstm_350m", "mixtral_8x22b")
B, MAX_LEN, S, STEPS = 2, 64, 24, 8
ATOL = 2e-3
TEACHER_FRAC = 0.35


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(pallas_interpret, arch):
    (rcfg, rp), (pcfg, pp) = smoke_models(arch)
    toks = np.random.RandomState(5).randint(
        0, rcfg.vocab, (B, S + STEPS)).astype(np.int32)
    rs = RT.init_decode_state(rcfg, B, MAX_LEN)
    ps = T.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    addrs = [t.data_ptr() for t in _state_tensors(ps)]
    prefill = jax.jit(lambda p, t, s: RT.prefill(p, t, rcfg, s))
    decode = jax.jit(lambda p, t, s, q: RT.decode_step(p, t, rcfg, s, q))
    rl, rs = prefill(rp, jnp.asarray(toks[:, :S]), rs)
    pl, ps = T.prefill(pp, torch.from_numpy(toks[:, :S]), pcfg, ps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL)
    teacher, _ = RT.forward_train(rp, jnp.asarray(toks), rcfg, remat=False)
    teacher = np.asarray(teacher)
    scale = float(teacher.std()) + 1e-6
    worst = 0.0
    for j in range(STEPS):
        pos = np.full((B,), S + j, np.int32)
        tok = toks[:, S + j:S + j + 1]
        rl, rs = decode(rp, jnp.asarray(tok), rs, jnp.asarray(pos))
        pl, ps = T.decode_step(pp, torch.from_numpy(tok), pcfg, ps,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL,
                                   err_msg=f"decode step {j}")
        worst = max(worst, float(np.abs(pl.numpy()
                                        - teacher[:, S + j]).max()))
    assert worst / scale < TEACHER_FRAC, (worst, scale)
    # the state was updated in place: every tensor kept its address
    assert [t.data_ptr() for t in _state_tensors(ps)] == addrs


def _state_tensors(state) -> list:
    out = []
    for entry in state:
        fields = (("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v")
                  if isinstance(entry, QuantizedKVCache)
                  else tuple(f.name for f in dataclasses.fields(entry)))
        out += [getattr(entry, f) for f in fields]
    return out


def _state_tensors(state) -> list:
    out = []
    for entry in state:
        fields = (("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v")
                  if isinstance(entry, QuantizedKVCache)
                  else tuple(f.name for f in dataclasses.fields(entry)))
        out += [getattr(entry, f) for f in fields]
    return out
