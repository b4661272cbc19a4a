"""The port's model against the reference on internlm2_1_8b smoke, with the
reference's weights bridged through numpy and both configs in float32 (so
the comparison is about the algorithm, not bf16 rounding). The reference
runs its Pallas kernels in interpret mode (`pallas_interpret` fixture).

Chunk-prefill logits (two chunks: the second attends over the first's
pages and ends in a partial page) and decode-step logits agree within
atol 1e-4 (float32, summation orders differ); greedy `decode_scan`
tokens across page flushes are identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.models import transformer as T
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

B, MAX_LEN, C = 2, 64, 16
N_PAGES = B * MAX_LEN // 8 + 1


def _setup():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    table = (1 + np.random.RandomState(0).permutation(N_PAGES - 1)).reshape(
        B, -1).astype(np.int32)
    rstate = RT.init_decode_state(rcfg, B, MAX_LEN, paged=True,
                                  n_pages=N_PAGES)
    rstate["p0"] = dataclasses.replace(
        rstate["p0"], page_table=jnp.broadcast_to(
            jnp.asarray(table), rstate["p0"].page_table.shape))
    pstate = T.init_decode_state(pcfg, B, MAX_LEN, paged=True,
                                 n_pages=N_PAGES, device="cpu")
    for c in pstate:
        c.page_table = torch.from_numpy(table)
    return (rcfg, rparams, rstate), (pcfg, pparams, pstate)


def test_bridge_keeps_every_weight():
    (rcfg, rparams, _), (pcfg, pparams, _) = _setup()
    blocks = rparams["blocks"]["p0"]
    for i, layer in enumerate(pparams["layers"]):
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for n in names:
                np.testing.assert_array_equal(layer[group][n].numpy(),
                                              np.asarray(blocks[group][n][i]))
    np.testing.assert_array_equal(pparams["embed"].numpy(),
                                  np.asarray(rparams["embed"]))
    assert len(pparams["layers"]) == pcfg.n_layers


def test_prefill_decode_and_greedy_scan_match(pallas_interpret):
    (rcfg, rp, rs), (pcfg, pp, ps) = _setup()
    rng = np.random.RandomState(1)
    toks = rng.randint(0, rcfg.vocab, (2, B, C)).astype(np.int32)
    chunks = [(np.zeros(B, np.int32), np.full(B, C, np.int32), 0),
              (np.full(B, C, np.int32), np.asarray([C, 5], np.int32), 2)]
    mask = np.ones(B, bool)
    for (start, valid, hb), tk in zip(chunks, toks):
        rl, rs = RT.prefill_chunk(rp, jnp.asarray(tk), rcfg, rs,
                                  start=jnp.asarray(start),
                                  row_mask=jnp.asarray(mask), hist_blocks=hb,
                                  valid=jnp.asarray(valid))
        pl, ps = T.prefill_chunk(pp, torch.from_numpy(tk), pcfg, ps,
                                 start=torch.from_numpy(start),
                                 row_mask=torch.from_numpy(mask),
                                 hist_blocks=hb,
                                 valid=torch.from_numpy(valid))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=1e-4)

    tok = np.array(jnp.argmax(rl[:, :rcfg.vocab], -1), np.int32)[:, None]
    pos = (chunks[1][0] + chunks[1][1]).astype(np.int32)
    rl, rs = RT.decode_step(rp, jnp.asarray(tok), rcfg, rs, jnp.asarray(pos))
    pl, ps = T.decode_step(pp, torch.from_numpy(tok), pcfg, ps,
                           torch.from_numpy(pos))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=1e-4)

    tok = np.array(jnp.argmax(rl[:, :rcfg.vocab], -1), np.int32)[:, None]
    pos = pos + 1                      # rows at 33 / 22: flushes at 40, 24, 32
    r_pend, rs, r_toks = RT.decode_scan(rp, jnp.asarray(tok), rcfg, rs,
                                        jnp.asarray(pos), steps=12)
    p_pend, ps, p_toks = T.decode_scan(pp, torch.from_numpy(tok), pcfg, ps,
                                       torch.from_numpy(pos), steps=12)
    np.testing.assert_array_equal(p_toks.numpy(), np.asarray(r_toks))
    np.testing.assert_array_equal(p_pend.numpy(), np.asarray(r_pend))
    np.testing.assert_array_equal(ps[0].length.numpy(),
                                  np.asarray(rs["p0"].length)[0])


def test_entry_points_refuse_unported_architectures():
    cfg = dataclasses.replace(port_cfgs.smoke(), sliding_window=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, device="cpu")
    # a mixed plan is served, from the page pool only (the reference's
    # error; tests/test_torch_mixed_plan.py holds the plan paths)
    with pytest.raises(ValueError, match="requires the paged cache"):
        T.init_decode_state(port_cfgs.smoke(), 2, 64, kv_cache_dtype=(
            "int8", "int4"), device="cpu")
