"""Logical axes -> mesh axes, the mesh of `torch.distributed` ranks, and
its collectives (port of ``repro.parallel.shard``).

The model code names the dimensions of parameters and activations by
*logical* axes ("batch", "heads", "fsdp", ...). `logical_spec` maps them
onto whatever mesh is active, dimension by dimension, with the
reference's divisibility fallbacks:

    single pod   (data=16, model=16)
    multi pod    (pod=2, data=16, model=16)   -- "pod" composes with "data"

A spec is a tuple with one entry a dimension: the tuple of mesh axes that
shard it (``()`` replicated), the entries of the reference's
``PartitionSpec`` as tuples.

Where the reference leaves the layouts inside a jitted step to GSPMD and
writes the collectives of its ``shard_map`` bodies, the port holds each
rank's shard and writes every collective. `Mesh` is a
``torch.distributed.device_mesh.init_device_mesh`` over the ranks, with
this rank's coordinates and a process group for each set of axes. Its
collectives are differentiable (`all_gather`, `reduce_scatter`,
`all_reduce`), each with its transpose. The convention: every rank's
autograd holds its *share* of a cotangent, and the shares of all ranks
sum to the whole. So the backward of an all-gather is a reduce-scatter,
that of a reduce-scatter an all-gather, and that of an all-reduce an
all-reduce (the shares of a replicated value summed); a loss computed on
several ranks at once is counted once by scaling each rank's share, and a
parameter used whole on several ranks gets its gradient all-reduced over
them (`training.step`).

The backend follows from the layout and is decided once
(`init_distributed`): NCCL when each rank has a card of its own, gloo
otherwise. On gloo every collective on a CUDA tensor goes through a
pinned host buffer, whatever op it is. No path falls back from one
backend to the other. Each collective adds its calls, the bytes a rank
sends on a ring (all-gather and reduce-scatter (n - 1) / n of the whole,
all-reduce twice that) and its host seconds to ``Mesh.stats``, by op and
axes.

Outside `mesh_context` every caller runs its one-device path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import threading
import time
from collections import defaultdict

import torch

# logical axis -> preferred physical mesh axes (the axes present in the
# mesh, in this order, whose product divides the dimension)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),      # data parallel (pods stack with data)
    "heads": ("model",),           # tensor parallel over attention heads
    "kv_heads": ("model",),        # replicated if too few heads
    "ffn": ("model",),             # tensor parallel over the MLP hidden dim
    "vocab": ("model",),           # embedding / logits vocab sharding
    "fsdp": ("pod", "data"),       # zero-style parameter sharding
    "seq_shard": ("model",),       # sequence / context parallelism
    "embed": (),
    "seq": (),
    "expert": (),                  # experts TP'd internally, no EP
    "pages": (),                   # page pool replicated over data
}

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return LOGICAL_RULES


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate a mesh for the code inside."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


class MeshShape:
    """A mesh's axis names and sizes, without processes: what specs are
    computed from (`Mesh` adds the ranks)."""

    def __init__(self, axis_names, sizes):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against sizes {self.sizes}")

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"

    @property
    def key(self) -> tuple:
        return self.axis_names, self.sizes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _axes_for(name, dim_size: int, mesh):
    """One logical dim: the mesh axes of its rule that exist, dropping
    axes from the end until their product divides ``dim_size`` (None:
    replicated)."""
    if name is None:
        return None
    want = current_rules().get(name, ())
    axes = tuple(a for a in want if a in mesh.axis_names)
    if not axes:
        return None
    prod = math.prod(mesh.shape[a] for a in axes)
    while axes and dim_size % prod:
        prod //= mesh.shape[axes[-1]]
        axes = axes[:-1]
    return axes or None


def logical_spec(logical, shape, mesh) -> tuple[tuple[str, ...], ...]:
    """Each dimension's mesh axes (a mesh axis shards one dimension at
    most: a later dimension drops the axes an earlier one took)."""
    parts, used = [], set()
    for name, size in zip(logical, shape):
        axes = _axes_for(name, size, mesh)
        axes = tuple(a for a in axes or () if a not in used)
        if not axes or size % math.prod(mesh.shape[a] for a in axes):
            parts.append(())
            continue
        used.update(axes)
        parts.append(axes)
    return tuple(parts)


# -- the mesh of ranks ----------------------------------------------------------

def backend_for(placements) -> str:
    """The backend of ranks computing at ``placements``, each rank's
    (host, card UUID, or "cpu"): NCCL when every rank has a card of its
    own, gloo when ranks share a card or compute on the CPU. Ranks on
    cards and on the CPU at once raise `ValueError`."""
    on_cpu = {p[1] == "cpu" for p in placements}
    if len(on_cpu) > 1:
        raise ValueError(f"ranks compute on cards and on the CPU at once: "
                         f"{placements}")
    if True in on_cpu or len(set(placements)) < len(placements):
        return "gloo"
    return "nccl"


def placement(device) -> tuple[str, str]:
    """Where this rank computes: (host, the card's UUID, or "cpu"). The
    UUID tells cards apart whatever CUDA_VISIBLE_DEVICES numbers them."""
    import socket
    device = torch.device(device)
    card = "cpu" if device.type != "cuda" else \
        str(torch.cuda.get_device_properties(device).uuid)
    return socket.gethostname(), card


def init_distributed(device, *, rank: int | None = None,
                     world: int | None = None, init_method: str | None = None,
                     timeout_s: float = 600.0) -> str:
    """Start the default process group (once) for ranks on ``device``:
    rank, world size and rendezvous from the arguments or from
    ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR /
    MASTER_PORT); a world of one without a rendezvous takes a free
    localhost port. The ranks first post their `placement` in the
    rendezvous's store, and every rank starts the backend that
    `backend_for` gives for all of them. Returns it; a collective that
    waits past ``timeout_s`` raises."""
    import json

    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world == 1:
            import socket
            with socket.socket() as s:
                s.bind(("localhost", 0))
                init_method = f"tcp://localhost:{s.getsockname()[1]}"
        else:
            raise ValueError("a world of several ranks needs a rendezvous: "
                             "run under torchrun or pass init_method")
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world = next(dist.rendezvous(init_method, rank, world,
                                              timeout=timeout))
    store.set_timeout(timeout)
    device = torch.device(device)
    store.set(f"placement/{rank}", json.dumps(placement(device)))
    backend = backend_for([tuple(json.loads(store.get(f"placement/{r}")))
                           for r in range(world)])
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank, world_size=world, timeout=timeout)
    return backend


class Mesh(MeshShape):
    """The ranks of the default process group as a mesh of ``sizes`` over
    ``axis_names`` (row-major: rank = the row-major index of its
    coordinates, as the reference's device order). ``device`` is where
    this rank computes; ``coords`` its coordinate on each axis."""

    def __init__(self, sizes, axis_names, device):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        super().__init__(axis_names, sizes)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.rank = dist.get_rank()
        self.device_mesh = init_device_mesh(
            "cuda" if self.backend == "nccl" else "cpu", self.sizes,
            mesh_dim_names=self.axis_names)
        self.coords = {a: self.device_mesh.get_local_rank(a)
                       for a in self.axis_names}
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in self.axis_names}
        # a group for every set of two or more axes, made on every rank in
        # one order (rank lists row-major over the set's axes)
        for n in range(2, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                mine, _ = dist.new_subgroups_by_enumeration(
                    self._rank_lists(axes))
                self._groups[axes] = mine
        self.stats = defaultdict(lambda: [0, 0, 0.0])

    def _rank_lists(self, axes) -> list[list[int]]:
        others = [a for a in self.axis_names if a not in axes]
        strides = {a: math.prod(self.sizes[i + 1:])
                   for i, a in enumerate(self.axis_names)}
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = sum(c * strides[a] for a, c in zip(others, fixed))
            out.append([base + sum(c * strides[a] for a, c in zip(axes, cs))
                        for cs in itertools.product(
                            *(range(self.shape[a]) for a in axes))])
        return out

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or names) in the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [a for a in axes if a not in self.axis_names]
        if bad:
            raise ValueError(f"axes {bad} are not in the mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def index(self, axes) -> tuple[int, int]:
        """(this rank's row-major index over ``axes``, their size)."""
        axes = self.axes(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i, math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        axes = self.axes(axes)
        return self._groups[axes] if axes else None

    # -- collectives (no autograd; see the module functions) ---------------

    def _count(self, op, axes, nbytes, t0):
        s = self.stats[(op, axes)]
        s[0] += 1
        s[1] += int(nbytes)
        s[2] += time.perf_counter() - t0

    def _host(self, t):
        if not self.staged:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _back(self, t):
        return t.to(self.device) if self.staged else t

    def all_gather(self, x, axes, dim: int):
        """The shards of ``axes`` concatenated along ``dim`` (index
        order)."""
        import torch.distributed as dist
        axes = self.axes(axes)
        n = self.index(axes)[1]
        t0 = time.perf_counter()
        xt = self._host(x.movedim(dim, 0).contiguous())
        out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                          device=xt.device)
        dist.all_gather(list(out.chunk(n)), xt, group=self.group(axes))
        out = self._back(out).movedim(0, dim)
        self._count("all_gather", axes, out.numel() * out.element_size()
                    * (n - 1) / n, t0)
        return out

    def reduce_scatter(self, x, axes, dim: int):
        """The sum over ``axes`` of ``x``, this rank's chunk of it along
        ``dim``."""
        import torch.distributed as dist
        axes = self.axes(axes)
        n = self.index(axes)[1]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        t0 = time.perf_counter()
        xt = self._host(x.movedim(dim, 0).contiguous())
        chunks = list(xt.chunk(n))
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=self.group(axes))
        out = self._back(out).movedim(0, dim)
        self._count("reduce_scatter", axes, x.numel() * x.element_size()
                    * (n - 1) / n, t0)
        return out

    def all_reduce(self, x, axes, op: str = "sum"):
        """The sum (or max) over ``axes``; ``x`` is left unchanged."""
        import torch.distributed as dist
        axes = self.axes(axes)
        n = self.index(axes)[1]
        t0 = time.perf_counter()
        h = self._host(x) if self.staged else x.contiguous().clone()
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group(axes))
        out = self._back(h)
        self._count(f"all_reduce_{op}", axes, 2 * x.numel()
                    * x.element_size() * (n - 1) / n, t0)
        return out

    def barrier(self):
        import torch.distributed as dist
        dist.barrier()


# -- differentiable collectives ------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.reduce_scatter(g, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.all_gather(g, axes, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


def all_gather(x, axes, dim: int, mesh=None):
    """Differentiable all-gather along ``dim`` (the reference's tiled
    ``all_gather``); its transpose is `reduce_scatter`."""
    mesh = mesh or current_mesh()
    return _AllGather.apply(x, mesh, mesh.axes(axes), dim)


def reduce_scatter(x, axes, dim: int, mesh=None):
    """Differentiable reduce-scatter along ``dim`` (``psum_scatter``,
    tiled); its transpose is `all_gather`."""
    mesh = mesh or current_mesh()
    return _ReduceScatter.apply(x, mesh, mesh.axes(axes), dim)


def all_reduce(x, axes, mesh=None):
    """Differentiable sum over ``axes`` (``psum``); under the shares
    convention (module docstring) its transpose is itself."""
    mesh = mesh or current_mesh()
    return _AllReduce.apply(x, mesh, mesh.axes(axes))


# -- shards ----------------------------------------------------------------------

def shard_slices(spec, shape, mesh) -> tuple[slice, ...]:
    """This rank's slice of each dimension of a ``shape`` array laid out
    by ``spec``."""
    out = []
    for axes, size in zip(spec, shape):
        if not axes:
            out.append(slice(None))
            continue
        i, n = mesh.index(axes)
        out.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(out)


def take_shard(x, spec, mesh):
    """This rank's shard of the whole array ``x`` (numpy or torch; a
    view)."""
    return x[shard_slices(spec, x.shape, mesh)]


def full_shape(local_shape, spec, mesh) -> tuple[int, ...]:
    return tuple(s * math.prod(mesh.shape[a] for a in axes)
                 for s, axes in zip(local_shape, spec))


def gather_param(w, spec, mesh, keep=()):
    """A stored shard -> the array a block computes with: gathered
    (differentiably) along every dimension whose axes are not in
    ``keep``; a dimension sharded over ``keep`` stays this rank's."""
    for dim, axes in enumerate(spec):
        if not axes or all(a in keep for a in axes):
            continue
        if any(a in keep for a in axes):
            raise ValueError(f"dim {dim} of spec {spec} mixes kept axes "
                             f"{keep} with others")
        w = all_gather(w, axes, dim, mesh)
    return w


def spec_leaves(specs) -> list:
    """The specs of a spec tree in `core.tree.leaves` order (dict keys
    sorted; a spec, a tuple of tuples, is one leaf)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [] if specs is None else [specs]


def unused_axes(spec, mesh) -> tuple[str, ...]:
    """The mesh axes a leaf of ``spec`` is replicated over."""
    used = {a for axes in spec for a in axes}
    return tuple(a for a in mesh.axis_names if a not in used)


@torch.no_grad()
def gather_leaf(x, spec, mesh):
    """One leaf's shards -> the whole array, on every rank."""
    for dim, axes in enumerate(spec):
        if axes:
            x = mesh.all_gather(x, axes, dim)
    return x


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the (B, S, d) activations between blocks live: rows over the
    ``batch`` axes and positions over the ``seq`` axes (the reference's
    ``act_shard(x, "batch", "seq_shard", None)``), at global batch B and
    sequence S."""
    mesh: Mesh
    B: int
    S: int
    batch: tuple[str, ...]
    seq: tuple[str, ...]

    @classmethod
    def of(cls, mesh, B: int, S: int, d: int) -> "Layout":
        spec = logical_spec(("batch", "seq_shard", None), (B, S, d), mesh)
        return cls(mesh, B, S, spec[0], spec[1])

    def rows(self) -> slice:
        return shard_slices((self.batch,), (self.B,), self.mesh)[0]

    def positions(self) -> slice:
        return shard_slices((self.seq,), (self.S,), self.mesh)[0]

    @property
    def rep(self) -> int:
        """Ranks that hold the same rows."""
        return self.mesh.size // self.mesh.index(self.batch)[1] \
            if self.batch else self.mesh.size

    def to_layout(self, y, partial: tuple[str, ...]):
        """A whole-sequence (B_l, S, d) value -> this layout: summed over
        the ``partial`` axes where each rank holds a part of the sum (a
        reduce-scatter over the sequence when it is sharded over the same
        axes, else an all-reduce), or this rank's positions of a value
        every rank holds whole."""
        if partial:
            if self.seq:
                if tuple(partial) != self.seq:
                    raise ValueError(f"partial sums over {partial} against "
                                     f"sequence shards over {self.seq}")
                return reduce_scatter(y, self.seq, 1, self.mesh)
            return all_reduce(y, partial, self.mesh)
        return y[:, self.positions()] if self.seq else y

    def whole_seq(self, x):
        """(B_l, S_l, d) -> (B_l, S, d): the sequence gathered over its
        axes (differentiable; the transpose reduce-scatters)."""
        return all_gather(x, self.seq, 1, self.mesh) if self.seq else x


# -- paged KV cache specs (core/paging.py) ---------------------------------------
#
# The page pool replicates over "data" and shards its kv_heads dim over
# "model"; page tables and lengths are batch-sharded host metadata.

PAGE_POOL_LOGICAL: dict[str, tuple] = {
    "k_q": ("pages", None, "kv_heads", None),   # (n_pages, ps, H_kv, D)
    "v_q": ("pages", None, "kv_heads", None),
    "k_s": ("pages", "kv_heads", None),         # (n_pages, H_kv, D)
    "v_s": ("pages", "kv_heads", None),
    "free_stack": (None,),
    "n_free": (),
}

PAGED_CACHE_LOGICAL: dict[str, tuple] = {
    "page_table": ("batch", None),              # (B, max_blocks)
    "resid_k": ("batch", "kv_heads", None, None),
    "resid_v": ("batch", "kv_heads", None, None),
    "length": ("batch",),
}


def _shape(v) -> tuple:
    return tuple(getattr(v, "shape", ()))


def page_pool_specs(pool, mesh) -> dict:
    """{field: spec} for the fields of a `PagePool` that it has."""
    return {f: logical_spec(PAGE_POOL_LOGICAL[f], _shape(getattr(pool, f)),
                            mesh)
            for f in PAGE_POOL_LOGICAL if hasattr(pool, f)}


def paged_cache_specs(cache, mesh) -> dict:
    """{"pool": `page_pool_specs`, field: spec} for a
    `PagedQuantizedKVCache`."""
    return {"pool": page_pool_specs(cache.pool, mesh), **{
        f: logical_spec(PAGED_CACHE_LOGICAL[f], _shape(getattr(cache, f)),
                        mesh)
        for f in PAGED_CACHE_LOGICAL}}
