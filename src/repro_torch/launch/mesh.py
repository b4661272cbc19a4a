"""Meshes of ranks (port of ``repro.launch.mesh``): the reference's
shapes and axis names over the ranks of the default process group
(`parallel.shard.init_distributed` starts it), and the card's rates the
roofline divides by (`launch.roofline`).

Importing this module starts nothing and imports no torch: the rates
are plain numbers (chip_smoke.py reads them before it has a card).
"""
from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM5), at its 700 W power limit: the published
# rates of the card the port runs on (NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 column; dense rates, no sparsity). A card set below
# 700 W runs slower under load, so these bound it from below.
PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12          # float32 outside the tensor cores (no
#                                 TF32), FLOP/s: the port's float32
#                                 products and paged prefill's bound
HBM_BW = 3.35e12                # HBM3, bytes/s
HBM_BYTES = 80e9                # HBM3, bytes a card
# NVLink 4 (18 links), 900 GB/s both directions together: 450e9 bytes/s
# each way a GPU. The collective term divides a rank's sent bytes by it;
# a mesh past one node's 8 cards (the 256-rank pod) crosses a slower
# network between nodes, so there the term is a lower bound.
NVLINK_BW = 450e9


def _mesh(sizes, axes, device):
    import torch.distributed as dist

    from repro_torch.parallel.shard import Mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for s in sizes:
        need *= s
    if world != need:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {need} "
                         f"ranks; the process group has {world}")
    return Mesh(sizes, axes, device)


def production_shape(multi_pod: bool = False):
    """(sizes, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(device, *, multi_pod: bool = False):
    """(data=16, model=16), or (pod=2, data=16, model=16) over two pods:
    "pod" composes with "data" for data parallelism, "model" carries
    tensor, sequence and cache sharding."""
    return _mesh(*production_shape(multi_pod), device)


def make_host_mesh(device):
    """The one-rank mesh (data=1, model=1)."""
    return _mesh((1, 1), ("data", "model"), device)
