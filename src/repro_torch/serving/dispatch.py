"""Captured dispatch of the paged server's step functions: the port's
counterpart of the reference's ``jax.jit`` around decode, the decode-scan
chunks, the sampler and chunk prefill (the reference has no such module:
jit is its compiler).

A `Step` wraps one step function. Where its `GraphDispatch` is disabled
(on the CPU, on the contiguous backend, or forced eager) it calls the
function. Otherwise it captures one `torch.cuda.CUDAGraph` per shape key
at first use and replays it after that. The shape key is what jit would
trace again on: each tensor argument's shape and dtype (a dict of tensors
by its keys), and which optional arguments are None: batch, chunk width,
greedy or sampled, masked or not.

What a step function must keep for its graph to be valid:
  * every tensor it reads or writes that is not an argument (weights,
    pools, residuals, lengths, page tables) keeps its address until
    `GraphDispatch.new_generation`, which drops every graph (the
    scheduler starts a generation whenever it rebuilds its state);
  * it makes no host sync and no host-to-device copy;
  * its non-tensor outputs are arguments (the state, returned as passed);
  * a tensor argument it writes in place is the one it was captured on
    (a persistent buffer): the graph writes its static inputs.

Tensor arguments are the graph's static inputs: the tensors passed at
capture (or clones of them, for the positions in ``copy_in``), refilled
by ``copy_`` on a later call that passes other tensors. The scheduler
passes persistent buffers, so nothing is copied. Tensor outputs live in
the generation's graph pool, where a graph captured earlier may use the
same bytes for its intermediates: right after each replay they are
copied into buffers allocated outside the capture, and a call returns
those buffers, valid until that graph's next replay. So graphs sharing
the pool may replay in any order (one stream, one replay at a time).

Capture executes nothing, so the first call of a key first runs the
function once eagerly on a scratch state (``scratch()``, the same
structure with its own tensors) and on clones of its tensor arguments (a
step may write its inputs in place, as the decode scan's step advances
its carry), on the capture stream: every lazy first-time action (a kernel
library's load, a kernel's shared-memory attribute, cuBLAS's workspace on
that stream) happens there, never inside the capture and never on the
live state. Then it captures and replays once. A capture or replay error
raises: there is no eager retry.

Launch counters: the kernel wrappers (`repro_torch.kernels.COUNTED`)
count in Python, so a capture counts what the graph holds and a replay
counts nothing. The warm-up's and the capture's counts are taken back;
each graph keeps what its capture counted and adds it at every replay, so
the counters read as eager dispatch would. Nothing here runs at import
time.
"""
from __future__ import annotations

import time
import weakref

import torch

from repro_torch.kernels import COUNTED

_STREAMS: dict = {}      # device -> the capture stream (cuBLAS keeps a
                         # workspace per stream: one stream, one workspace)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def _read_counts() -> dict:
    """Each counted wrapper's (launches, {dtype: launches})."""
    return {f: (f.launches, dict(getattr(f, "launches_by_dtype", {})))
            for f in COUNTED}


def _write_counts(counts: dict) -> None:
    for f in COUNTED:
        n, by = counts.get(f, (0, {}))
        f.launches = n
        for k in getattr(f, "launches_by_dtype", {}):
            f.launches_by_dtype[k] = by.get(k, 0)


def _count_delta(after: dict, before: dict) -> list:
    """(wrapper, launches, {dtype: launches}) for each wrapper whose count
    moved between two `_read_counts`."""
    out = []
    for f, (n1, by1) in after.items():
        n0, by0 = before.get(f, (0, {}))
        by = {k: v - by0.get(k, 0) for k, v in by1.items()
              if v != by0.get(k, 0)}
        if n1 != n0 or by:
            out.append((f, n1 - n0, by))
    return out


def _arg_key(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype)
    if isinstance(a, dict):
        return tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(a.items()))
    raise TypeError(f"a step's argument is a tensor, a dict of tensors or "
                    f"None (or listed as opaque), got {type(a).__name__}")


def _shapes(a):
    """An argument's shapes as JSON (None stays None: greedy, unmasked)."""
    if isinstance(a, dict):
        return {k: list(v.shape) for k, v in sorted(a.items())}
    return None if a is None else list(a.shape)


def _clone(a):
    """A tensor argument's (or a dict's) clone; anything else as passed."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: v.clone() for k, v in a.items()}
    return a


def _tensors(a) -> list:
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, dict):
        return [v for _, v in sorted(a.items())]
    return []


class _Graph:
    """One captured graph: its static inputs (argument position, tensors),
    the opaque arguments it was captured on, its outputs (in the pool),
    their buffers, where each returned item comes from, and the launch
    counts one replay stands for."""

    __slots__ = ("graph", "inputs", "opaque", "outputs", "buffers", "outs",
                 "single", "counts")


class Step:
    """A step function under `GraphDispatch` (see the module docstring),
    named ``name`` in the capture records. ``opaque`` are the argument
    positions held by identity (weights, the state), ``state_arg`` the one
    the warm-up replaces by a scratch state, ``copy_in`` tensor arguments
    whose static inputs are clones (one that arrives from several buffers,
    such as the sampler's logits)."""

    def __init__(self, dispatch: "GraphDispatch", fn, *, name: str,
                 opaque=(), state_arg: int | None = None, copy_in=()):
        self.dispatch, self.fn, self.name = dispatch, fn, name
        self.opaque, self.state_arg = frozenset(opaque), state_arg
        self.copy_in = frozenset(copy_in)
        self.graphs: dict[tuple, _Graph] = {}

    def key(self, args) -> tuple:
        return tuple(None if j in self.opaque else _arg_key(a)
                     for j, a in enumerate(args))

    def __call__(self, *args):
        d = self.dispatch
        if not d.enabled:
            return self.fn(*args)
        key = self.key(args)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = d._capture(self, args)
        else:
            for j, obj in g.opaque:
                if args[j] is not obj:
                    raise RuntimeError(
                        f"argument {j} is not the object the graph was "
                        f"captured on: the state changed without a new "
                        f"generation (GraphDispatch.new_generation)")
            for j, static in g.inputs:
                for s, t in zip(static, _tensors(args[j])):
                    if t.data_ptr() != s.data_ptr():
                        s.copy_(t)
        g.graph.replay()
        for buf, o in zip(g.buffers, g.outputs):
            buf.copy_(o)
        d.replays += 1
        for f, n, by in g.counts:
            f.launches += n
            for k, v in by.items():
                f.launches_by_dtype[k] += v
        out = tuple(g.buffers[i] if src == "out" else args[i]
                    for src, i in g.outs)
        return out[0] if g.single else out


class GraphDispatch:
    """The capture context of one engine: whether steps are captured
    (``enabled``: the card and the paged backend; clear it to force eager
    dispatch), the state generation, one graph memory pool per generation
    and the process's capture stream. ``scratch()`` builds a state of the
    live one's structure for the warm-up. Counts replays and records each
    capture: its generation, step, shape key, and the seconds of its
    warm-up and of the capture itself (graph instantiation included)."""

    def __init__(self, device, *, enabled: bool, scratch=None):
        self.device = torch.device(device)
        self.enabled = enabled
        self.scratch = scratch
        self.generation = 0
        self.pool = None
        self.replays = 0
        self.captured: list[dict] = []
        self._steps: weakref.WeakSet = weakref.WeakSet()

    @property
    def captures(self) -> int:
        return len(self.captured)

    @property
    def capture_s(self) -> float:
        """Wall seconds of every capture, warm-ups included."""
        return sum(c["warm_s"] + c["capture_s"] for c in self.captured)

    def step(self, fn, **kw) -> Step:
        s = Step(self, fn, **kw)
        self._steps.add(s)
        return s

    def new_generation(self) -> None:
        """The state is rebuilt: every graph points into the old one and is
        dropped (after the card has finished with it), with its output
        buffers and the old pool."""
        if any(s.graphs for s in self._steps):
            torch.cuda.synchronize(self.device)
            for s in self._steps:
                s.graphs.clear()
        self.pool = None
        self.generation += 1

    def pool_bytes(self) -> int:
        """Device bytes the generation's graph pool holds (0 before its
        first capture)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _capture(self, step: Step, args) -> _Graph:
        t0 = time.perf_counter()
        dev = self.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = _read_counts()
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            wargs = [a if j in step.opaque else _clone(a)
                     for j, a in enumerate(args)]
            if step.state_arg is not None:
                wargs[step.state_arg] = self.scratch()
            step.fn(*wargs)
            del wargs
        torch.cuda.current_stream(dev).wait_stream(stream)
        g = _Graph()
        cargs = list(args)
        for j in step.copy_in:
            cargs[j] = args[j].clone()
        g.inputs = [(j, _tensors(a)) for j, a in enumerate(cargs)
                    if j not in step.opaque and a is not None]
        g.opaque = [(j, args[j]) for j in step.opaque]
        warmed = _read_counts()
        t1 = time.perf_counter()
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=self.pool, stream=stream):
            res = step.fn(*cargs)
        g.counts = _count_delta(_read_counts(), warmed)
        _write_counts(before)
        g.single = not isinstance(res, tuple)
        res = (res,) if g.single else res
        state = None if step.state_arg is None else args[step.state_arg]
        g.outputs = [o for o in res if isinstance(o, torch.Tensor)]
        g.outs = [("out", sum(isinstance(p, torch.Tensor) for p in res[:i]))
                  if isinstance(o, torch.Tensor) else
                  ("arg", step.state_arg) if o is state and o is not None
                  else None for i, o in enumerate(res)]
        if None in g.outs:
            raise TypeError("a step's outputs are tensors and its state "
                            "argument")
        g.buffers = [torch.empty_like(o) for o in g.outputs]
        self.captured.append({
            "generation": self.generation, "step": step.name,
            "shapes": [_shapes(a) for j, a in enumerate(args)
                       if j not in step.opaque],
            "warm_s": t1 - t0, "capture_s": time.perf_counter() - t1})
        return g
