"""Where a mesh's ranks compute and what each holds (JAX-free):

- `parallel.shard.backend_for` over the ranks' placements (host, card
  UUID): NCCL when every rank has a card of its own, however
  CUDA_VISIBLE_DEVICES numbers them (one visible card a rank: each rank's
  cuda:0, distinct UUIDs), gloo when ranks share a card or compute on
  the CPU, and a `ValueError` for ranks on cards and on the CPU at once;
- `launch.specs.init_shards` draws the same weights as
  `transformer.init_params` (whisper_small: `encdec.init_params`) and
  keeps each rank's shards bit for bit those of the whole tree cut by
  `shard_tree`, at every coordinate of the (data 2, model 2) and (pod 2,
  data 1, model 2) meshes, and no shard holds the storage of a whole
  leaf; its hook sees the embedding, the head and one layer at a time
  (whisper_small: each encoder and decoder layer, the embedding, the
  two norms);
- `launch.specs.serve_param_specs` (tensor-parallel serving, every
  family) cuts every attention weight on whole heads at every coordinate
  of the (data 2, model 2) and (data 1, model 4) meshes (kv heads fewer
  than "model" whole on every rank, query heads split where a rank's lie
  in one kv head, `attention.head_slice`; whisper_small's encoder, self
  and cross attention), the mLSTM's q / k / v on whole heads, the
  RG-LRU's channels, the FFN, vocabulary and output columns over
  "model" and nothing over "data"; the RG-LRU's weight channel slices
  equal its serving state's (two spec functions, compared slice by
  slice); the sLSTM's leaves whole, and under `SSM_RULES` no leaf cut;
  and a tree in training's layout (`param_specs`, whose "heads" cut
  splits a kv head at (1, 4)) re-cut by `parallel.shard.refit` is bit
  for bit the serving layout's shards (each gather answered from the
  whole leaf, without processes), for the attention, MoE, recurrent and
  encoder-decoder stacks;
- `mesh_context` restores the mesh it found.
"""
import dataclasses
import itertools
import socket

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.launch import specs as SP
from repro_torch.models import attention as A
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.parallel.shard import (SSM_RULES, Mesh, MeshShape,
                                        backend_for, current_mesh,
                                        mesh_context, placement, refit,
                                        shard_slices, spec_leaves,
                                        take_shard)

CARD = ("GPU-3f1c0c52-0a8e-7b1d-5c2e-9d40aa0c1e01",
        "GPU-8b2d7e14-61f0-4c3a-9e55-0b7f3c2d9a12",
        "GPU-c47a9e03-2d15-48b6-a1f8-6e3d9b0c5f23",
        "GPU-e92b1f66-7c04-4d8e-b3a1-2f5e8c7d0b34")


@pytest.mark.parametrize("placements,want", [
    # one visible card a rank (CUDA_VISIBLE_DEVICES=r): all cuda:0
    ([("h0", CARD[r]) for r in range(4)], "nccl"),
    # two hosts, two cards each
    ([("h0", CARD[0]), ("h0", CARD[1]), ("h1", CARD[0]), ("h1", CARD[1])],
     "nccl"),
    ([("h0", CARD[0])], "nccl"),
    # four ranks sharing one card
    ([("h0", CARD[0])] * 4, "gloo"),
    # two of four on one card
    ([("h0", CARD[0]), ("h0", CARD[0]), ("h0", CARD[1]), ("h0", CARD[2])],
     "gloo"),
    ([("h0", "cpu")] * 4, "gloo"),
    ([("h0", "cpu")], "gloo"),
], ids=["one-visible-card-a-rank", "two-hosts", "one-rank", "shared",
        "partly-shared", "cpu", "cpu-one"])
def test_backend_follows_the_placements(placements, want):
    assert backend_for(placements) == want


def test_ranks_on_cards_and_cpu_raise():
    with pytest.raises(ValueError, match="on cards and on the CPU"):
        backend_for([("h0", CARD[0]), ("h0", "cpu")])


def test_placement_on_the_cpu():
    assert placement("cpu") == (socket.gethostname(), "cpu")


class CoordMesh(MeshShape):
    """A mesh's shape seen from one coordinate, without processes."""
    axes = Mesh.axes
    index = Mesh.index

    def __init__(self, axis_names, sizes, coords):
        super().__init__(axis_names, sizes)
        self.coords = dict(zip(axis_names, coords))


def _coords(sizes):
    return itertools.product(*(range(n) for n in sizes))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_moe_a2_7b",
                                  "qwen2_vl_2b", "whisper_small"])
@pytest.mark.parametrize("mesh", [((2, 2), ("data", "model")),
                                  ((2, 1, 2), ("pod", "data", "model"))],
                         ids=["2x2", "pod"])
def test_init_shards_are_the_whole_init_cut(arch, mesh):
    sizes, axes = mesh
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    specs = SP.param_specs(cfg, MeshShape(axes, sizes))
    init = E.init_params if cfg.family == "encdec" else T.init_params
    whole = init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for c in _coords(sizes):
        m = CoordMesh(axes, sizes, c)
        want = SP.shard_tree(whole, specs, m)
        got = SP.init_shards(cfg, torch.Generator().manual_seed(3), "cpu",
                             specs, m)
        for a, b in zip(leaves(got), leaves(want), strict=True):
            assert torch.equal(a, b), c
            assert a.untyped_storage().nbytes() == a.numel() \
                * a.element_size(), c


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "whisper_small"])
def test_init_params_hands_over_one_part_at_a_time(arch):
    cfg = get_config(arch, smoke=True)
    seen = []

    def keep(key, part):
        seen.append(key)
        return part
    if cfg.family == "encdec":
        E.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                      keep=keep)
        assert seen == [("enc_layers", i) for i in range(
            cfg.n_encoder_layers)] + [("dec_layers", i) for i in range(
                cfg.n_layers)] + [("embed",), ("enc_norm",), ("final_norm",)]
        return
    T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                  keep=keep)
    assert seen == [("embed",), ("final_norm",), ("lm_head",)] + [
        ("layers", i) for i in range(cfg.n_layers)]


TP_MESHES = {"2x2": ((2, 2), ("data", "model")),
             "1x4": ((1, 4), ("data", "model"))}
# (arch, smoke): the smoke configs' kv heads 2 or 4; qwen2_vl_2b's 12 / 2
# at full width (G 6: 3 query heads a rank at (1, 4), one kv head read);
# recurrentgemma_9b's one kv head (query heads split, kv whole), its
# RG-LRU channels; xlstm_350m's mLSTM heads and sLSTM; whisper_small's
# encoder, self and cross attention
TP_ARCHS = [("internlm2_1_8b", True), ("qwen2_moe_a2_7b", True),
            ("codeqwen1_5_7b", True), ("mixtral_8x22b", True),
            ("qwen2_vl_2b", False), ("qwen2_5_32b", False),
            ("recurrentgemma_9b", True), ("recurrentgemma_9b", False),
            ("xlstm_350m", True), ("whisper_small", True)]
ATTN = ("attn", "self_attn", "cross_attn")
RGLRU_CHANNELS = ("w_in", "w_gate", "conv_w", "lam", "w_a", "b_a", "w_x",
                  "b_x")


def _blocks(shapes, specs):
    """(kind, parameters, specs) of each mixer and FFN of every layer (a
    decoder's ``layers``, whisper's ``enc_layers`` and ``dec_layers``)."""
    for key in ("layers", "enc_layers", "dec_layers"):
        for lp, ls in zip(shapes.get(key, ()), specs.get(key, ())):
            for kind in lp:
                if not kind.startswith("norm"):
                    yield kind, lp[kind], ls[kind]


def _norms(shapes, specs):
    """(name, leaf, spec) of every norm leaf: each layer's ``norm*`` (a
    decoder's ``layers``, whisper's ``enc_layers`` and ``dec_layers``)
    and the stack's ``final_norm`` / ``enc_norm``."""
    tops = [(k, shapes[k], specs[k]) for k in ("final_norm", "enc_norm")
            if k in shapes]
    for key in ("layers", "enc_layers", "dec_layers"):
        for i, (lp, ls) in enumerate(zip(shapes.get(key, ()),
                                         specs.get(key, ()))):
            tops += [(f"{key}[{i}].{k}", lp[k], ls[k]) for k in lp
                     if k.startswith("norm")]
    for name, lp, ls in tops:
        for leaf in lp:
            yield f"{name}.{leaf}", lp[leaf], ls[leaf]


def _cols(spec, shape, m) -> tuple[int, int]:
    """[start, stop) of this coordinate's last dim of a leaf."""
    return shard_slices(spec, shape, m)[-1].indices(shape[-1])[:2]


@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("arch,smoke", TP_ARCHS)
def test_serve_specs_cut_whole_heads(arch, smoke, mesh):
    """Whole units cut at every coordinate: attention on whole query and
    kv heads, the mLSTM's ``wq`` / ``wk`` / ``wv`` on whole heads (its
    gate projection whole), the RG-LRU's channels, every FFN's hidden
    channels and every output projection's d_model columns over "model",
    the vocabulary's rows; nothing over "data"; the sLSTM and every norm
    (each layer's, the final and the encoder's) whole."""
    sizes, axes = TP_MESHES[mesh]
    cfg = get_config(arch, smoke=smoke)
    specs = SP.serve_param_specs(cfg, MeshShape(axes, sizes))
    shapes = SP.param_shapes(cfg)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = sizes[1]
    kv_split, G = Hkv % n == 0, H // Hkv
    for sp, leaf in zip(spec_leaves(specs), leaves(shapes), strict=True):
        assert all(a in ((), ("model",)) for a in sp), sp   # no "data"
    seen, model = set(), ("model",)
    for c in _coords(sizes):
        m = CoordMesh(axes, sizes, c)
        for kind, lp, ls in _blocks(shapes, specs):
            if kind in ATTN:
                heads = A.head_slice(cfg, ls, m)
                for name, units, (h0, h1) in (("wq", H, heads["q"]),
                                              ("wk", Hkv, heads["kv"]),
                                              ("wv", Hkv, heads["kv"])):
                    lo, hi = _cols(ls[name], lp[name].shape, m)
                    assert (lo, hi) == (h0 * hd, h1 * hd), (name, c, lo, hi)
                assert heads["kv"] == ((0, Hkv) if not kv_split else (
                    c[1] * Hkv // n, (c[1] + 1) * Hkv // n))
                q0, q1 = heads["q"]
                assert q1 - q0 == H // n, (c, heads)  # every case splits q
                r0, r1 = heads["reads"]
                assert (r0, r1) == (q0 // G, (q1 - 1) // G + 1)
                if kv_split:
                    assert (r0, r1) == heads["kv"]
                else:
                    assert r1 - r0 == 1, heads        # one kv head read
                seen.add((c[1], q0))
                assert ls["wo"] == ((), model)
            elif kind in ("mlp", "moe"):
                for name in ("w_gate", "w_up", "w_down"):
                    assert ls[name][-1] == model, (name, ls[name])
                    assert ls[name][:-1] == ((),) * (lp[name].dim() - 1)
                if kind == "moe":
                    assert ls["router"] == ((), ())
            elif kind == "rglru":
                w = cfg.rnn_width
                for name in RGLRU_CHANNELS:
                    assert _cols(ls[name], lp[name].shape, m) == (
                        c[1] * w // n, (c[1] + 1) * w // n), (name, c)
                assert ls["w_out"] == ((), model)
            elif kind == "mlstm":
                dh, hl = cfg.d_model // H, H // n
                for name in ("wq", "wk", "wv"):       # whole heads
                    assert _cols(ls[name], lp[name].shape, m) == (
                        c[1] * hl * dh, (c[1] + 1) * hl * dh), (name, c)
                assert ls["w_if"] == ((), ()) and ls["b_if"] == ((),)
                assert ls["wo"] == ((), model)
            else:                                     # slstm: whole
                assert kind == "slstm", kind
                assert all(a == () for sp in ls.values() for a in sp), ls
        n_norms = 0
        for name, leaf, sp in _norms(shapes, specs):  # norms whole
            assert sp == ((),) * leaf.dim(), (name, sp)
            assert all(s == slice(None) for s in shard_slices(
                sp, leaf.shape, m)), (name, c)
            n_norms += 1
        assert n_norms >= 1 + len(shapes.get("layers", ())), n_norms
    assert specs["embed"] == (model, ())
    if "lm_head" in specs:
        assert specs["lm_head"] == ((), model)
    if any(k in ATTN for k, _, _ in _blocks(shapes, specs)):
        assert len(seen) == n               # each "model" rank its heads


@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_rglru_weight_channels_are_its_states(smoke, mesh):
    """The RG-LRU's weights and its serving state come from two spec
    functions (`serve_param_specs`, `serve_state_specs`): at every
    coordinate the channel slices of ``w_in``, ``w_gate``, ``conv_w`` and
    the gate vectors equal those of the state's ``h`` and ``conv``, so a
    step touches only the rank's own state."""
    sizes, axes = TP_MESHES[mesh]
    cfg = get_config("recurrentgemma_9b", smoke=smoke)
    shape = MeshShape(axes, sizes)
    specs = SP.serve_param_specs(cfg, shape)
    states, whole = SP.serve_state_specs(cfg, 4, 512, shape)
    shapes = SP.param_shapes(cfg)
    n_rglru = 0
    for c in _coords(sizes):
        m = CoordMesh(axes, sizes, c)
        for i, (lp, ls) in enumerate(zip(shapes["layers"],
                                         specs["layers"])):
            if "rglru" not in lp:
                continue
            st, sw = states[i], whole[i]
            h = shard_slices(st["h"], sw.h.shape, m)[1]
            conv = shard_slices(st["conv"], sw.conv.shape, m)[2]
            assert h.indices(cfg.rnn_width) == conv.indices(cfg.rnn_width)
            for name in RGLRU_CHANNELS:
                got = shard_slices(ls["rglru"][name],
                                   lp["rglru"][name].shape, m)[-1]
                assert got.indices(cfg.rnn_width) == h.indices(
                    cfg.rnn_width), (i, name, c, got, h)
            assert h.indices(cfg.rnn_width)[:2] != (0, cfg.rnn_width)
            n_rglru += 1
    assert n_rglru


@pytest.mark.parametrize("rules", ["default", "ssm"])
def test_slstm_leaves_whole_and_ssm_cuts_nothing(rules):
    """The sLSTM's leaves are whole on every rank by layout, under either
    rules; under `SSM_RULES` ("model" holds rows) no leaf of xlstm_350m
    is cut at all."""
    sizes, axes = TP_MESHES["1x4"]
    cfg = get_config("xlstm_350m", smoke=False)
    with mesh_context(None, SSM_RULES if rules == "ssm" else None):
        specs = SP.serve_param_specs(cfg, MeshShape(axes, sizes))
    kinds = [k for k, _, _ in _blocks(SP.param_shapes(cfg), specs)]
    assert kinds.count("slstm") == 3
    for kind, _, ls in _blocks(SP.param_shapes(cfg), specs):
        if kind == "slstm" or rules == "ssm":
            assert all(a == () for sp in ls.values() for a in sp), (kind,
                                                                    ls)
    if rules == "ssm":
        assert all(a == () for sp in spec_leaves(specs) for a in sp)


class GatherMesh(CoordMesh):
    """A coordinate's view that answers `refit`'s gathers from the whole
    leaf: each gather makes a dimension whole, the others as this
    coordinate holds them."""

    def __init__(self, axis_names, sizes, coords, whole, have):
        super().__init__(axis_names, sizes, coords)
        self.whole, self.cur = whole, list(have)

    def all_gather(self, x, axes, dim):
        self.cur[dim] = ()
        return take_shard(self.whole, tuple(self.cur), self)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_9b", "xlstm_350m",
                                  "whisper_small"])
def test_training_layout_refits_to_serving(arch):
    """Saved at (2, 2) or (1, 4) in training's layout, re-cut at (1, 4)
    (a checkpoint is whole on disk: where it was saved does not
    matter): every leaf's training shard refitted is bit for bit its
    serving shard."""
    sizes, axes = TP_MESHES["1x4"]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    shape = MeshShape(axes, sizes)
    have, want = SP.param_specs(cfg, shape), SP.serve_param_specs(cfg, shape)
    init = E.init_params if cfg.family == "encdec" else T.init_params
    whole = init(cfg, torch.Generator().manual_seed(5), device="cpu")
    # the trap: training's cut halves a kv head
    if cfg.n_kv_heads % 4 and "attn" in have["layers"][0]:
        assert have["layers"][0]["attn"]["wk"][1] == ("model",)
        assert want["layers"][0]["attn"]["wk"][1] == ()
    moved = 0
    for c in _coords(sizes):
        for w, h, s in zip(leaves(whole), spec_leaves(have),
                           spec_leaves(want), strict=True):
            m = GatherMesh(axes, sizes, c, w, h)
            got = refit(take_shard(w, h, m), h, s, m)
            assert torch.equal(got, take_shard(w, s, m)), (c, h, s)
            moved += tuple(h) != tuple(s)
    assert moved > 0


def test_mesh_context_restores_the_mesh():
    outer, inner = MeshShape(("data",), (2,)), MeshShape(("model",), (2,))
    assert current_mesh() is None
    with mesh_context(outer):
        with mesh_context(inner):
            assert current_mesh() is inner
        assert current_mesh() is outer
    assert current_mesh() is None
