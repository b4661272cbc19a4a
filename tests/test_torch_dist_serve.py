"""The port's sharded serving over the contiguous INT8 cache on 4 gloo
ranks on the CPU (each a process of the JAX-free
tests/torch_dist_worker.py): `make_serve_fns` under `mesh_context`, the
cache's rows over "data" and its slots over "model"
(`launch.specs.cache_shardings`), against the reference's jitted
UNSHARDED `make_serve_fns` on the same numpy weights (helpers and
tolerances in tests/torch_serve_parity.py).

internlm2_1_8b per block and per channel, qwen2_moe_a2_7b (the MoE
routes every rank's whole sequence in the prefill),
qwen2_vl_2b (M-RoPE), codeqwen1_5_7b and qwen2_5_32b (QKV bias) and
llama3_2_3b, smoke in float32, each on meshes (data 2, model 2)
and (data 1, model 4): 4 prompts of 24 tokens, max_len 48, then 8
decode steps teacher-forced on the reference's greedy stream (a block
flush at position 31). At (2, 2) a rank holds 24 slots, so the second
"model" rank has no prompt slot and merges m = -1e30 until the flush,
which it owns (its scale row 0); at (1, 4) 48 slots make 6 blocks over
4 ranks: ``k_q`` is sharded (12 slots a rank) and ``k_s`` replicated,
blocks straddle two ranks (the flushed block 3 lies on the third).
Checked on every rank: logits within ATOL and the greedy tokens
identical, the logits bit for bit the same on every rank, every decode
step sending the same bytes, and its cache (its rows, slots and scale
rows) against the reference cache's slice by the page rule. These
stacks serve tensor parallel (`launch.specs.serve_param_specs`; at
(1, 4) the smoke configs' 2 kv heads stay whole on every rank, the
query heads split): each rank holds exactly its shards' bytes, no leaf
the specs split whole, nothing gathered, and every decode step and the
prefill send the activation bytes `torch_serve_parity.tp_sent` reckons
(`check_tensor_parallel`). Also: a decode from the reference's own
prefill state carried into each rank's shards
(`checkpoint.bridge.serve_state_from_numpy`, bit for bit), and weights
saved in training's layout at (2, 2) served at (1, 4) after
`launch.specs.refit_tree` (the restored tree itself refused). And the
dry run's fake trace of internlm's (2, 2) run against what its gloo
ranks recorded (bytes by collective, weight and state bytes: exact).

The long-context stacks (`RECURRENT`): recurrentgemma_9b (RG-LRU and a
local-attention ring) per block and per channel and mixtral_8x22b (a
sliding-window ring) on 40-token prompts, so the 16-slot smoke ring has
wrapped twice at the prefill (4 slots a rank at (1, 4), blocks of 8
straddling two ranks, the scale rows replicated, and once the residual
holds 4 tokens or more a rank whose slots the window leaves dead, which
merges m = -1e30), and the block flush at position 47 lands on the
ring's second block; xlstm_350m (mLSTM / sLSTM)
under the default rules and under `SSM_RULES`. Each rank's ring and
recurrent states are held against the reference state's slice where
`launch.specs.cache_shardings` puts its shard (`check_state`);
every one serves tensor parallel as above (`check_tensor_parallel`:
the RG-LRU's channels, the mLSTM's heads, the sLSTM whole by layout,
the bytes of the RG-LRU's hidden and column gathers, the mLSTM's
q / k / v head gather, readout all-reduce and prefill state refit;
under `SSM_RULES` no leaf split). And (`SQ_CASES`) the sharded decode
of `models.recurrent_mesh` over an mLSTM and an RG-LRU state on the
layer's weight shards, with and without ``state_quant`` (the RG-LRU's
row scale a MAX over its channels' ranks), against the reference's
`mlstm_step` / `apply_step` (6 steps from the int8 initial state:
outputs, the state's shards, the weight bytes held and each step's
bytes by collective).

The encoder-decoder (`ENCDEC`): whisper_small per block, tensor
parallel (its encoder over every frame with its heads split, its cross
K/V projected on a rank's kv heads and gathered, q's heads gathered in
decode: `check_tensor_parallel`), its self caches sharded as
the decoders' and its per-channel cross caches' `enc_cache_len` slots
over "model", at its smoke encoder_seq 24 (24 slots: 12 a rank at
(2, 2), 6 at (1, 4)) and at 20 and 12 (`dataclasses.replace`): 20
frames pad to 24 slots, so at (1, 4) the last rank holds 2 live slots
of 6; 12 pad to 16, so the last rank holds only padding and merges
m = -1e30. Held as the decoders (logits, tokens, the self caches by the
page rule; the scale rows of the block a decode step flushes from the
bf16 residual within one bf16 step, `check_contiguous`), and each
rank's cross cache against the reference's slice (int8 by the page
rule, scales within SCALE_RTOL, lengths the true encoder length); both
caches against the port's own unsharded run's (scales bit for bit: the
absmax of a rank's slots MAX-reduced over the ranks is the absmax of
all, and the padding's zeros move none; int8 by the page rule)."""
import numpy as np
import pytest

import torch_serve_parity as SV
from repro_torch.models import encdec
from torch_dist import run_ranks
from torch_dist_worker import load_tree, save_tree
from torch_dryrun import fake_serve_ranks

CASES = [("internlm2_1_8b", "per_block"), ("internlm2_1_8b", "per_channel"),
         ("qwen2_moe_a2_7b", "per_block"), ("qwen2_vl_2b", "per_block"),
         ("codeqwen1_5_7b", "per_block"), ("qwen2_5_32b", "per_block"),
         ("llama3_2_3b", "per_block")]
# (arch, granularity, rules, prompt length)
RECURRENT = [("recurrentgemma_9b", "per_block", "default", 40),
             ("recurrentgemma_9b", "per_channel", "default", 40),
             ("mixtral_8x22b", "per_block", "default", 40),
             ("xlstm_350m", "per_block", "default", 24),
             ("xlstm_350m", "per_block", "ssm", 24)]
# (arch, the layer's kind, rules) of the state_quant decode
SQ_CASES = [("xlstm_350m", "mlstm", "default"), ("xlstm_350m", "mlstm", "ssm"),
            ("recurrentgemma_9b", "rglru", "default")]
SQ_STEPS = 6
# (arch, encoder_seq): the cross caches' padding across the ranks' slots
ENCDEC = [("whisper_small", 24), ("whisper_small", 20),
          ("whisper_small", 12)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's reference run in this process (and an
    encoder-decoder's unsharded port run), then every sharded run in
    one 4-rank job."""
    d = tmp_path_factory.mktemp("serve")
    refs, tasks = {}, []
    for arch, gran in CASES:
        rcfg, rparams = SV.models(arch, gran)
        toks = SV.tokens(rcfg)
        ref = SV.run_reference(rcfg, rparams, toks)
        key = f"{arch}-{gran}"
        refs[key] = (rcfg, ref)
        w, b = SV.write_inputs(d, key, rparams, toks, ref)
        for m in SV.MESHES:
            tasks.append(SV.serve_task(arch, m, w, b, d / f"{key}.{m}",
                                       granularity=gran))
        if key == "internlm2_1_8b-per_block":
            save_tree(d / "prefill_state.npz", ref["prefill_state"])
            tasks.append(SV.serve_task(
                arch, "2x2", w, b, d / "carried", granularity=gran,
                ref_state=str(d / "prefill_state.npz")))
            # saved in training's layout at (2, 2), served at (1, 4)
            tasks.append({**SV.serve_task(arch, "2x2", w, b, None),
                          "kind": "save_params", "ckpt": str(d / "ckpt")})
            tasks.append(SV.serve_task(arch, "1x4", w, b, d / "refit",
                                       granularity=gran,
                                       ckpt=str(d / "ckpt")))
    for arch, gran, rules, s in RECURRENT:
        rcfg, rparams = SV.models(arch, gran)
        toks = SV.tokens(rcfg, s=s)
        ref = SV.run_reference(rcfg, rparams, toks)
        key = f"{arch}-{gran}-{rules}"
        refs[key] = (rcfg, ref)
        w, b = SV.write_inputs(d, key, rparams, toks, ref)
        for m in SV.MESHES:
            tasks.append(SV.serve_task(arch, m, w, b, d / f"{key}.{m}",
                                       granularity=gran, rules=rules))
    for arch, kind, rules in SQ_CASES:
        for sq in (False, True):
            key = f"sq-{arch}-{rules}-{sq}"
            refs[key] = SV.recurrent_reference(arch, kind, sq, SQ_STEPS,
                                               d / f"{key}.in.npz")
            for m in SV.MESHES:
                tasks.append(SV.recurrent_task(arch, kind, m, sq, rules,
                                               d / f"{key}.in.npz",
                                               d / f"{key}.{m}"))
    for arch, enc in ENCDEC:
        rcfg, rparams = SV.models(arch, encoder_seq=enc)
        toks, frames = SV.tokens(rcfg), SV.frames(rcfg)
        ref = SV.run_reference(rcfg, rparams, toks, frames=frames)
        key = f"{arch}-{enc}"
        w, b = SV.write_inputs(d, key, rparams, toks, ref, frames)
        refs[key] = (rcfg, ref, SV.run_port_encdec(arch, enc, w, b))
        for m in SV.MESHES:
            tasks.append(SV.serve_task(arch, m, w, b, d / f"{key}.{m}",
                                       replace={"encoder_seq": enc}))
    run_ranks(d, 4, tasks, name="serve")
    return d, refs


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("arch,gran", CASES)
def test_sharded_serving_matches_reference(results, arch, gran, mesh):
    d, refs = results
    rcfg, ref = refs[f"{arch}-{gran}"]
    ranks = [load_tree(d / f"{arch}-{gran}.{mesh}.{r}.npz")
             for r in range(4)]
    for r, got in enumerate(ranks):
        label = f"{arch} {gran} {mesh} rank {r}"
        SV.check_logits(got["logits"], ref["logits"], rcfg.vocab, label)
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"],
                                      err_msg=f"{label}: ranks differ")
        assert len(set(got["sent"].tolist())) == 1, (label, got["sent"])
        SV.check_contiguous(got["state"], ref["state"], got["where"], label)
        SV.check_tensor_parallel(got, rcfg, mesh, label)
    where = [g["where"] for g in ranks]
    model = 2 if mesh == "2x2" else 4
    assert {tuple(w["slots"]) for w in where} == {
        (i * 48 // model, (i + 1) * 48 // model) for i in range(model)}
    if mesh == "1x4" and gran == "per_block":     # 6 blocks over 4 ranks
        assert all(tuple(w["scales"]) == (0, 6) for w in where)


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("arch,gran,rules,s", RECURRENT)
def test_sharded_long_context_serving_matches_reference(results, arch, gran,
                                                        rules, s, mesh):
    """Logits and greedy tokens as `test_sharded_serving_matches_reference`
    holds them, and every layer's ring or recurrent state against the
    reference's slice."""
    d, refs = results
    key = f"{arch}-{gran}-{rules}"
    rcfg, ref = refs[key]
    ranks = [load_tree(d / f"{key}.{mesh}.{r}.npz") for r in range(4)]
    for r, got in enumerate(ranks):
        label = f"{key} {mesh} rank {r}"
        SV.check_logits(got["logits"], ref["logits"], rcfg.vocab, label)
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"],
                                      err_msg=f"{label}: ranks differ")
        assert len(set(got["sent"].tolist())) == 1, (label, got["sent"])
        SV.check_state(got["state"], ref["state"], got["slices"], rcfg,
                       label)
        SV.check_tensor_parallel(got, rcfg, mesh, label, s=s, rules=rules)
    if rcfg.sliding_window:                       # the ring's slots split
        n_model = SV.MESHES[mesh][1]
        slots = {tuple(g["slices"][f"{_first_attn(rcfg)}.k_q"][2])
                 for g in ranks}
        assert len(slots) == n_model, slots


def test_fake_trace_matches_the_ranks(results):
    """The dry run's fake trace (`launch.dryrun.trace_serve` on a fake
    process group, every rank in turn; tests/torch_dryrun.py) of the
    smoke internlm2_1_8b per-block prefill of 4 x 24 tokens and one decode
    step at max_len 48 on (2, 2): each rank's bytes by collective and
    axes, its weight bytes and its state bytes exactly what the real gloo
    ranks of this batch recorded."""
    d, _ = results
    fake = fake_serve_ranks("internlm2_1_8b", "per_block", "float32",
                            SV.MESHES["2x2"], SV.B, SV.S, SV.MAX_LEN)
    sent = lambda x: {k: int(v) for k, v in x.items() if int(v)}
    for r in range(4):
        got = load_tree(d / f"internlm2_1_8b-per_block.2x2.{r}.npz")
        f = fake[r]
        assert f["prefill"]["coll_detail"] == sent(got["prefill_sent"]), r
        assert f["decode"]["coll_detail"] == sent(got["decode_sent"]), r
        for kind in ("prefill", "decode"):
            assert f[kind]["weight_bytes"] == \
                int(got["params"]["held_bytes"]), r
            assert f[kind]["state_bytes"] == int(got["state_bytes"]), r
        assert f["decode"]["rank_coords"] == {"data": r // 2,
                                              "model": r % 2}


def _first_attn(cfg) -> int:
    return next(i for i in range(cfg.n_layers)
                if cfg.block_kind(i) in ("attn", "local_attn", "moe"))


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("sq", [False, True], ids=["f32", "state_quant"])
@pytest.mark.parametrize("arch,kind,rules", SQ_CASES)
def test_sharded_recurrent_decode_matches_reference(results, arch, kind,
                                                    rules, sq, mesh):
    d, refs = results
    key = f"sq-{arch}-{rules}-{sq}"
    ranks = [load_tree(d / f"{key}.{mesh}.{r}.npz") for r in range(4)]
    SV.check_recurrent(refs[key], ranks, f"{key} {mesh}")
    rcfg = SV.models(arch)[0]
    for r, got in enumerate(ranks):
        SV.check_tensor_parallel(got, rcfg, mesh, f"{key} {mesh} rank {r}",
                                 prefill=None, rules=rules, only=kind,
                                 state_quant=sq)


def test_prefill_state_carried_into_shards(results):
    """The reference's own prefill state, carried into each rank's shards
    (bit for bit its slice), decodes to the reference's logits."""
    d, refs = results
    rcfg, ref = refs["internlm2_1_8b-per_block"]
    for r in range(4):
        got = load_tree(d / f"carried.{r}.npz")
        w = got["where"]
        rows, slots, scales = (slice(*w[k]) for k in
                               ("rows", "slots", "scales"))
        for key, layer in got["carried"].items():
            if key == "tail":
                continue
            want = ref["prefill_state"][key]
            for n, cut in (("k_q", slots), ("v_q", slots), ("k_s", scales),
                           ("v_s", scales)):
                np.testing.assert_array_equal(layer[n],
                                              want[n][:, rows, :, cut])
            np.testing.assert_array_equal(layer["resid_k"],
                                          want["resid_k"][:, rows])
        SV.check_logits(got["logits"], ref["logits"][1:], rcfg.vocab,
                        f"carried rank {r}")
        SV.check_contiguous(got["state"], ref["state"], w, f"carried {r}")
        SV.check_tensor_parallel(got, rcfg, "2x2", f"carried {r}",
                                 prefill=None)


def test_serving_from_a_training_checkpoint(results):
    """Weights saved on (data 2, model 2) in training's layout
    (`launch.specs.param_specs`: FSDP over "data", heads over "model" cut
    through the kv heads), restored on (data 1, model 4) and re-cut to
    the serving layout (`launch.specs.refit_tree`): held as the fresh
    (1, 4) run, and bit for bit its logits and cache; the restored tree
    itself, in training's layout, refused by the prefill (`ValueError`)
    rather than served or gathered."""
    d, refs = results
    rcfg, ref = refs["internlm2_1_8b-per_block"]
    for r in range(4):
        got = load_tree(d / f"refit.{r}.npz")
        fresh = load_tree(d / f"internlm2_1_8b-per_block.1x4.{r}.npz")
        label = f"refit rank {r}"
        assert got["refused"], (label, "training's layout served")
        SV.check_logits(got["logits"], ref["logits"], rcfg.vocab, label)
        SV.check_tensor_parallel(got, rcfg, "1x4", label)
        np.testing.assert_array_equal(got["logits"], fresh["logits"],
                                      err_msg=label)
        for key, layer in got["state"].items():
            for f, v in (layer.items() if isinstance(layer, dict) else ()):
                np.testing.assert_array_equal(v, fresh["state"][key][f],
                                              err_msg=f"{label} {key} {f}")


@pytest.mark.parametrize("mesh", list(SV.MESHES))
@pytest.mark.parametrize("arch,enc", ENCDEC)
def test_sharded_encdec_serving_matches_reference(results, arch, enc, mesh):
    d, refs = results
    key = f"{arch}-{enc}"
    rcfg, ref, port = refs[key]
    ranks = [load_tree(d / f"{key}.{mesh}.{r}.npz") for r in range(4)]
    n_model = SV.MESHES[mesh][1]
    slots = encdec.enc_cache_len(rcfg)
    for r, got in enumerate(ranks):
        label = f"{key} {mesh} rank {r}"
        SV.check_logits(got["logits"], ref["logits"], rcfg.vocab, label)
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"],
                                      err_msg=f"{label}: ranks differ")
        SV.check_tensor_parallel(got, rcfg, mesh, label)
        for k, flushed in (("self", SV.S // rcfg.quant.block_size),
                           ("cross", None)):
            SV.check_contiguous({k: got["state"][k]}, {k: ref["state"][k]},
                                got["where"][k], f"{label} {k}", flushed)
            w = got["where"][k]
            rows, cut, sc = (slice(*w[f]) for f in
                             ("rows", "slots", "scales"))
            mine, want = got["state"][k], port["state"][k]
            for n in ("k_s", "v_s"):
                np.testing.assert_array_equal(
                    mine[n], want[n][:, rows, :, sc],
                    err_msg=f"{label} {k} {n} (port)")
            for n in ("k_q", "v_q"):
                SV.close_int8(mine[n], want[n][:, rows, :, cut],
                              f"{label} {k} {n} (port)")
        w = got["where"]["cross"]
        assert w["slots"][1] - w["slots"][0] == slots // n_model, w
        np.testing.assert_array_equal(got["state"]["cross"]["length"],
                                      np.full(rcfg.n_layers, enc))
    # the last "model" rank's live cross slots: 2 of 6 at 20, none at 12
    lo, hi = ranks[-1]["where"]["cross"]["slots"]
    live = {24: slots // n_model, 20: 2 if n_model == 4 else 8,
            12: 0 if n_model == 4 else 4}[enc]
    assert max(min(enc, hi) - lo, 0) == live, (enc, mesh, lo, hi)
