"""The cost of one rank's step, counted while it runs on fake tensors
(the port's counterpart of ``repro.launch.hlo_cost``).

The reference compiles a cell and walks the partitioned HLO text. The
port has no HLO to parse: it runs eagerly, so the dry run runs the
rank's step itself under ``torch._subclasses.fake_tensor.FakeTensorMode``
(shapes and dtypes, no data, no card) and `CostMode`, a dispatch mode
beneath which every aten op passes, counts as it goes. Every figure is
one device's (one rank's), as the reference's post-partitioning shapes
are:

- **flops**: the dot operations, 2·M·N·K a product for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and the convolutions (``torch.utils.
  flop_counter``'s formulas, as the reference's ``_dot_flops``), with
  the part on float32 inputs kept apart (``flops_f32``: the card runs it
  outside the tensor cores); elementwise operations are not counted.
- **bytes**: each op's inputs plus its outputs, for every op that is not
  a view (``_unsafe_view``, a view but for its autograd flag, is one;
  an in-place op's result, the tensor it was given, counts once; a
  gather counts the rows it reads, not its whole table). The
  reference left standalone elementwise ops out because the TPU fuses
  them into their consumers; the port runs eagerly, each such op a
  kernel whose inputs and outputs really cross HBM, so they count.
- **collective bytes**: by op and axes, from `parallel.shard.Mesh.stats`
  (the ring counts: what a rank sends), where the reference summed the
  collectives' output shapes.
- **the hand-written kernels**: each costed by the work it does, reported
  by its wrapper (`kernels.ops` on a fake tensor: the bytes it must read
  and write and the operations it must do, the bases of PERF.md's bound
  column), not by its plain version's steps; e.g. paged decode reads its
  pages and scales once and never writes a dequantized copy (the
  reference needed a kernel-adjusted memory term for this).
- **peak**: the most bytes of storages the step allocated that were live
  at once (its temporaries and outputs, above its arguments).
- **bytes by op**: the bytes above by aten op (a kernel's by its name):
  where a cell's memory term comes from.

A host loop whose trips repeat the same work (`core.costing.host_loop`:
the sLSTM's token loop, the mLSTM's chunks, the microbatches) runs once
and counts its trips' worth, its collectives too (`CostMode.repeated`),
as the reference's ``evaluate`` multiplies a while body by its trip
count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import costing

aten = torch.ops.aten

# dot products: torch.utils.flop_counter's formulas
_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
         aten._convolution, aten.convolution_backward}
# allocations that touch no memory, and bookkeeping
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.detach,
         aten._local_scalar_dense, aten.resize_, aten.set_}
# gathers: the rows they read and write, and their indices
_GATHERS = {aten.index, aten.embedding, aten.index_select, aten.gather}


@dataclasses.dataclass
class Cost:
    """One device's counts (the fields of the reference's
    ``hlo_cost.Cost``, and the port's)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict[str, float] = dataclasses.field(default_factory=dict)
    flops_f32: float = 0.0
    coll_calls: dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: dict[str, dict] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    bytes_by_op: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class CostMode(TorchDispatchMode):
    """Counts every op beneath it (`Cost`); the recorder of
    `core.costing` while `measure` runs."""

    def __init__(self, collapse: bool = True, mesh=None):
        super().__init__()
        self.scale, self.collapse, self.mesh = 1, collapse, mesh
        self.flops = self.flops_f32 = self.bytes = 0.0
        self.kernels = defaultdict(lambda: {"launches": 0, "bytes": 0.0,
                                            "flops": 0.0})
        self.live = self.peak = 0
        self._storages: dict[int, int] = {}
        self.by_op = defaultdict(float)

    def kernel(self, name, nbytes, flops, f32):
        k = self.kernels[name]
        k["launches"] += self.scale
        k["bytes"] += nbytes * self.scale
        k["flops"] += flops * self.scale
        self.bytes += nbytes * self.scale
        self.by_op[name] += nbytes * self.scale
        self.flops += flops * self.scale
        if f32:
            self.flops_f32 += flops * self.scale

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Everything inside counts ``n`` times: its ops through
        ``scale``, and the calls and bytes its collectives added to the
        mesh's stats."""
        stats = self.mesh.stats if self.mesh is not None else {}
        before = {k: (s[0], s[1]) for k, s in stats.items()}
        prev, self.scale = self.scale, self.scale * n
        try:
            yield
        finally:
            self.scale = prev
            for k, s in stats.items():
                calls, nbytes = before.get(k, (0, 0))
                s[0] += (n - 1) * (s[0] - calls)
                s[1] += (n - 1) * (s[1] - nbytes)

    def _allocated(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key):
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace not in ("aten", "prims") or func.is_view or \
                packet is aten._unsafe_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and not any(t is i for i in ins)]
        for t in outs:
            self._allocated(t)
        if packet in _FREE:
            return out
        if packet in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:])
            nbytes = 2 * sum(_nbytes(t) for t in outs) + idx
        else:
            nbytes = sum(_nbytes(t) for t in ins + outs)
        self.bytes += nbytes * self.scale
        self.by_op[str(packet)] += nbytes * self.scale
        if packet in _DOTS:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f * self.scale
            if ins and ins[0].dtype == torch.float32:
                self.flops_f32 += f * self.scale
        return out


def measure(fn, mesh=None, collapse: bool = True):
    """Run ``fn()`` (its tensors fake, under an active ``FakeTensorMode``)
    and count it: (fn's result, `Cost`). ``mesh``: its `Mesh.stats`
    cleared first and read after (the collectives); ``collapse``: host
    loops run one trip (`core.costing.host_loop`)."""
    if mesh is not None:
        mesh.stats.clear()
    mode = CostMode(collapse, mesh)
    with mode, costing.recording(mode):
        out = fn()
    cost = Cost(flops=mode.flops, bytes=mode.bytes,
                flops_f32=mode.flops_f32, peak_bytes=mode.peak,
                kernels={k: dict(v) for k, v in mode.kernels.items()},
                bytes_by_op=dict(sorted(mode.by_op.items(),
                                        key=lambda kv: -kv[1])))
    if mesh is not None:
        for (op, axes), (calls, nbytes, _) in mesh.stats.items():
            key = f"{op}:{'+'.join(axes)}"
            cost.coll[key] = cost.coll.get(key, 0) + nbytes
            cost.coll_calls[key] = cost.coll_calls.get(key, 0) + calls
    return out, cost


def tree_bytes(*trees) -> int:
    """The bytes of the storages the tensors of ``trees`` use, each once:
    dicts, lists, tuples and objects' attributes walked (a cache's
    tensors, a pool's)."""
    seen, total = set(), 0

    def walk(x, depth=0):
        nonlocal total
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v, depth)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, depth)
        elif hasattr(x, "__dict__") and depth < 3 and not isinstance(
                x, type):
            for k, v in vars(x).items():
                if k != "mesh":
                    walk(v, depth + 1)
    for t in trees:
        walk(t)
    return total
