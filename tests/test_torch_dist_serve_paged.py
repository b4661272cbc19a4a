"""The port's sharded serving over the paged INT8 cache on 4 gloo ranks on
the CPU (tests/torch_dist_worker.py): `make_serve_fns(paged=True)` and
`make_chunk_prefill_fn` under `mesh_context`, the pool's kv heads over
"model" where `parallel.shard.paged_cache_specs` shards them, page
tables, residuals and lengths of the rank's rows over "data", against
the reference's jitted UNSHARDED functions on the same numpy weights
and page table (helpers and tolerances in tests/torch_serve_parity.py).

internlm2_1_8b and qwen2_vl_2b (2 kv heads: 1 a rank at (data 2, model
2); replicated at (data 1, model 4), Hkv < n_model, every rank all
heads) and qwen2_moe_a2_7b (4 kv heads: 2 and 1 a rank), smoke in
float32: 4 prompts of 24 tokens prefilled in one chunk through
`make_chunk_prefill_fn` (the paged prefill kernel), or for internlm also
whole through `make_serve_fns`' prefill (the flash forward and
`PagedQuantizedKVCache.prefill`), then 8 decode steps teacher-forced on
the reference's greedy stream (a page flush at position 31). The pages
come from a `HostPageAllocator` replicated on every rank: each rank's
hands out the reference allocator's table. Checked on every rank:
logits within ATOL and the greedy tokens identical, the same bits on
every rank, every step sending the same bytes, and its rows' tables,
lengths and residuals and its pool's pages of its rows at its kv heads
against the reference's by the page rule."""
import numpy as np
import pytest

import torch_serve_parity as SV
from torch_dist import run_ranks
from torch_dist_worker import load_tree

N_PAGES = 32
# (arch, prefill route)
CASES = [("internlm2_1_8b", "chunk"), ("internlm2_1_8b", "whole"),
         ("qwen2_moe_a2_7b", "chunk"), ("qwen2_vl_2b", "chunk")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's reference run in this process, then every sharded run
    in one 4-rank job."""
    d = tmp_path_factory.mktemp("paged")
    refs, tasks = {}, []
    for arch, route in CASES:
        rcfg, rparams = SV.models(arch)
        toks = SV.tokens(rcfg)
        ref = SV.run_reference(rcfg, rparams, toks, paged=True,
                               chunk=route == "chunk", n_pages=N_PAGES)
        key = f"{arch}-{route}"
        refs[key] = (rcfg, ref)
        w, b = SV.write_inputs(d, key, rparams, toks, ref)
        for m in SV.MESHES:
            tasks.append(SV.serve_task(arch, m, w, b, d / f"{key}.{m}",
                                       paged=True, n_pages=N_PAGES,
                                       chunk=route == "chunk"))
    run_ranks(d, 4, tasks, name="paged")
    return d, refs


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("arch,route", CASES)
def test_sharded_paged_serving_matches_reference(results, arch, route,
                                                 mesh):
    d, refs = results
    rcfg, ref = refs[f"{arch}-{route}"]
    ranks = [load_tree(d / f"{arch}-{route}.{mesh}.{r}.npz")
             for r in range(4)]
    n_model = 2 if mesh == "2x2" else 4
    shards = rcfg.n_kv_heads % n_model == 0
    for r, got in enumerate(ranks):
        label = f"{arch} {route} {mesh} rank {r}"
        # the replicated allocator: every rank's pages are the reference's
        np.testing.assert_array_equal(got["pages"], ref["table"],
                                      err_msg=label)
        SV.check_logits(got["logits"], ref["logits"], rcfg.vocab, label)
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"],
                                      err_msg=f"{label}: ranks differ")
        assert len(set(got["sent"].tolist())) == 1, (label, got["sent"])
        SV.check_paged(got["state"], ref["state"], got["where"], label)
        h0, h1 = got["where"]["heads"]
        if shards:          # this rank's kv heads of the pool's spec
            assert h1 - h0 == rcfg.n_kv_heads // n_model, label
        else:               # Hkv < n_model: the pool replicated
            assert (h0, h1) == (0, rcfg.n_kv_heads), label
