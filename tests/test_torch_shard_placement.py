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
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.parallel.shard import (Mesh, MeshShape, backend_for,
                                        current_mesh, mesh_context,
                                        placement)

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


def test_mesh_context_restores_the_mesh():
    outer, inner = MeshShape(("data",), (2,)), MeshShape(("model",), (2,))
    assert current_mesh() is None
    with mesh_context(outer):
        with mesh_context(inner):
            assert current_mesh() is inner
        assert current_mesh() is outer
    assert current_mesh() is None
