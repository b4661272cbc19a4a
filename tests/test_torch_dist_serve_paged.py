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
against the reference's by the page rule; tensor parallel as
tests/test_torch_dist_serve.py holds it (`check_tensor_parallel`: the
shards' bytes, nothing gathered, each step's and the prefill's bytes).

Other page formats (`DT_CASES`, internlm2_1_8b by chunk): every layer's
pages fp8_e4m3, every layer's int4, and a mixed per-layer plan (int8 then
int4: the reference keeps its ``p0`` as a list of layers), passed to
`make_serve_fns` as ``kv_cache_dtype``. The pages are held as above
(fp8 codes and int4 nibbles one step apart by the page rule) where every
layer above stores int8; below an fp8 or int4 layer the K/V both
packages quantize differ by more than float rounding
(tests/test_torch_mixed_plan_stacks.py measured int8 values 3 steps
apart), and there the tables, lengths and where the scale rows were
written are held equal. The logits: within ATOL of the port's own
unsharded run at every step, and of the reference's up to the page
flush at position 31; the step that reads the flushed page sees an fp8
or int4 value one step apart between the packages even unsharded (one
int4 step is 1/7 of the scale: the unsharded port's logits move up to
3.3e-2 there), so there the greedy tokens are held identical."""
import numpy as np
import pytest

import torch_serve_parity as SV
from torch_dist import run_ranks
from torch_dist_worker import load_tree

N_PAGES = 32
# (arch, prefill route)
CASES = [("internlm2_1_8b", "chunk"), ("internlm2_1_8b", "whole"),
         ("qwen2_moe_a2_7b", "chunk"), ("qwen2_vl_2b", "chunk")]
# (label, kv_cache_dtype) of internlm2_1_8b's 2 smoke layers, by chunk
DT_CASES = [("fp8_e4m3", "fp8_e4m3"), ("int4", "int4"),
            ("mixed", ["int8", "int4"])]


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
    rcfg, rparams = SV.models("internlm2_1_8b")
    toks = SV.tokens(rcfg)
    for label, kv in DT_CASES:
        ref = SV.run_reference(rcfg, rparams, toks, paged=True, chunk=True,
                               n_pages=N_PAGES, kv_cache_dtype=kv)
        key = f"dt-{label}"
        ref["port"] = SV.run_port("internlm2_1_8b", toks, ref["stream"],
                                  kv_cache_dtype=kv, n_pages=N_PAGES)
        refs[key] = (rcfg, ref)
        w, b = SV.write_inputs(d, key, rparams, toks, ref)
        for m in SV.MESHES:
            tasks.append(SV.serve_task("internlm2_1_8b", m, w, b,
                                       d / f"{key}.{m}", paged=True,
                                       n_pages=N_PAGES, chunk=True,
                                       kv_cache_dtype=kv))
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
        SV.check_tensor_parallel(got, rcfg, mesh, label, paged=True,
                                 prefill="chunk" if route == "chunk"
                                 else "prefill")
        h0, h1 = got["where"]["heads"]
        if shards:          # this rank's kv heads of the pool's spec
            assert h1 - h0 == rcfg.n_kv_heads // n_model, label
        else:               # Hkv < n_model: the pool replicated
            assert (h0, h1) == (0, rcfg.n_kv_heads), label


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("label,kv", DT_CASES, ids=[c[0] for c in DT_CASES])
def test_sharded_paged_formats_match_reference(results, label, kv, mesh):
    d, refs = results
    rcfg, ref = refs[f"dt-{label}"]
    plan = [kv] * rcfg.n_layers if isinstance(kv, str) else list(kv)
    ruled = {("p0", i): dt for i, dt in enumerate(plan)   # period 1
             if all(up == "int8" for up in plan[:i])}
    ranks = [load_tree(d / f"dt-{label}.{mesh}.{r}.npz") for r in range(4)]
    for r, got in enumerate(ranks):
        tag = f"{label} {mesh} rank {r}"
        np.testing.assert_array_equal(got["pages"], ref["table"],
                                      err_msg=tag)
        flush = 32 - SV.S                 # the first step after the flush
        SV.check_logits(got["logits"][:flush], ref["logits"][:flush],
                        rcfg.vocab, tag)
        SV.check_logits(got["logits"], ref["port"], rcfg.vocab,
                        f"{tag} against the unsharded port")
        np.testing.assert_array_equal(
            np.argmax(got["logits"][..., :rcfg.vocab], -1),
            np.argmax(ref["logits"][..., :rcfg.vocab], -1), err_msg=tag)
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"],
                                      err_msg=f"{tag}: ranks differ")
        assert len(set(got["sent"].tolist())) == 1, (tag, got["sent"])
        SV.check_tensor_parallel(got, rcfg, mesh, tag, paged=True,
                                 prefill="chunk")
        SV.check_paged_formats(got["state"], ref["state"], got["where"],
                               tag, ruled)
