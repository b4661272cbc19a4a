"""Meshes of ranks (port of ``repro.launch.mesh``): the reference's
shapes and axis names over the ranks of the default process group
(`parallel.shard.init_distributed` starts it).

The reference's TPU v5e constants (peak rate, HBM and ICI rates) belong
to its chip and are not carried over.
"""
from __future__ import annotations

from repro_torch.parallel.shard import Mesh


def _mesh(sizes, axes, device) -> Mesh:
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for s in sizes:
        need *= s
    if world != need:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {need} "
                         f"ranks; the process group has {world}")
    return Mesh(sizes, axes, device)


def make_production_mesh(device, *, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) over two pods:
    "pod" composes with "data" for data parallelism, "model" carries
    tensor, sequence and cache sharding."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device) -> Mesh:
    """The one-rank mesh (data=1, model=1)."""
    return _mesh((1, 1), ("data", "model"), device)
