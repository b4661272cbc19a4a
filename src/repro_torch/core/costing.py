"""What a cost trace (`launch.op_cost`) reads in the code it runs.

The dry run (`launch.dryrun`) runs one rank's step on fake tensors and
counts its work. Two things in the code under it take part; outside a
trace each is a no-op:

- a hand-written kernel's wrapper, given fake tensors, reports the work
  its kernel does (`kernel`: bytes read and written, operations) rather
  than run its plain version (`kernels.ops`);
- a host loop whose trips repeat the same work (`host_loop`) runs one
  trip, its ops and its collectives (`parallel.shard.Mesh.stats`)
  counted as many times as it has trips (the reference's cost model
  multiplies a while body by its trip count), where no backward outside
  the trip walks it.

The recorder is one per process, not per thread: the autograd engine
may run a backward on a thread of its own.
"""
from __future__ import annotations

import contextlib

import torch

_REC = [None]


def recorder():
    """The recorder of the trace in progress (None: no trace)."""
    return _REC[0]


@contextlib.contextmanager
def recording(rec):
    """Make ``rec`` the recorder for the code inside: it has ``collapse``
    (whether host loops run one trip), ``repeated(n)`` (a context in
    which everything counts ``n`` times) and ``kernel(name, nbytes,
    flops, f32)``."""
    prev, _REC[0] = _REC[0], rec
    try:
        yield rec
    finally:
        _REC[0] = prev


def kernel(name: str, nbytes: float, flops: float, *, f32: bool):
    """A hand-written kernel's work, reported by its wrapper on fake
    tensors: bytes read and written, operations (``f32``: at the float32
    rate, else the bf16 tensor cores')."""
    rec = _REC[0]
    if rec is not None:
        rec.kernel(name, nbytes, flops, f32)


class host_loop:
    """``range(n)`` for a host loop whose trips do the same work (the
    same ops on the same shapes). Under a trace that collapses loops it
    runs one trip, counted ``n`` times, where no autograd graph outlives
    a trip: grad off, or ``closed`` (each trip runs its own backward, as
    a microbatch does); a loop whose trips an outer backward walks runs
    every trip. `repeat` gives a list made in a collapsed loop its ``n``
    entries (each the one trip's)."""

    def __init__(self, n: int, closed: bool = False):
        self.n = n
        rec = _REC[0]
        self.once = (rec is not None and rec.collapse and n > 1
                     and (closed or not torch.is_grad_enabled()))

    def __iter__(self):
        if not self.once:
            yield from range(self.n)
            return
        with _REC[0].repeated(self.n):
            yield 0

    def repeat(self, items: list) -> list:
        return items * self.n if self.once else items
