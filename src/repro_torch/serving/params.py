"""Request-level sampling parameters and the engine configuration (port
of ``repro.serving.params``).

Field names are the reference's. Options whose machinery is not ported
yet raise `NotImplementedError` naming their ROADMAP item instead of
being silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.quantization import KV_DTYPES

# finish reasons a request can end with
FINISH_REASONS = ("stop_token", "stop_string", "length", "aborted")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request settings. ``temperature == 0`` is exact greedy argmax,
    the only arm ported (sampling needs ROADMAP queue 1, item 6).
    ``stop_token_ids`` finish a request when the NEXT token is one of them
    (the stop token itself is not emitted); ``stop`` strings are matched
    against the detokenized generated stream."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    stop_token_ids: tuple[int, ...] = ()
    stop: tuple[str, ...] = ()
    max_new_tokens: int = 16
    priority: int = 0
    kv_cache_dtype: str | None = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 "
                             f"(got {self.temperature})")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1] (got {self.top_p})")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k})")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not isinstance(self.priority, int):
            raise ValueError(f"priority must be an int "
                             f"(got {self.priority!r})")
        if self.kv_cache_dtype is not None and \
                self.kv_cache_dtype not in KV_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {KV_DTYPES} or "
                             f"None (got {self.kv_cache_dtype!r})")
        if self.temperature > 0:
            _not_ported("temperature > 0 (seeded sampling)",
                        "ROADMAP queue 1, item 6")
        if self.priority != 0:
            _not_ported("request priorities", "ROADMAP queue 1, item 9")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        object.__setattr__(self, "stop", tuple(self.stop))

    @classmethod
    def greedy(cls, **kw) -> "SamplingParams":
        return cls(temperature=0.0, **kw)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def default_detokenize(ids: Sequence[int]) -> str:
    """Each id renders as ``<id>``, so ``stop=("<7>",)`` stops on token 7."""
    return "".join(f"<{int(t)}>" for t in ids)


@dataclasses.dataclass
class EngineConfig:
    """One object configuring the serving stack: the reference's field
    names and defaults, with one difference: ``stall_ticks`` defaults to
    None (the reference's 500 arms a stall watchdog that is not ported
    yet, ROADMAP queue 1, item 9). Ported: ``batch``, ``max_len``,
    ``eos_id``, ``paged`` (False: the contiguous backend, the default;
    True: the page pool), ``n_pages``, ``chunk``, ``prefill_chunk`` (paged
    only), ``detokenize`` and a uniform ``kv_cache_dtype`` (other than
    int8: paged only). ``preempt_loop_limit`` is accepted and inert: it
    bounds preemption, which comes with overload (item 9). Every other
    option below that is set to anything but its off value raises
    `NotImplementedError`."""
    batch: int = 4
    max_len: int = 128
    eos_id: int | None = None
    paged: bool = False
    n_pages: int | None = None
    chunk: int | None = None
    prefix_cache: bool = False
    prefill_chunk: int | None = None
    detokenize: Callable[[Sequence[int]], str] | None = None
    use_fused_prefill: bool = True
    kv_cache_dtype: object = "int8"
    watermark: int | None = None
    aging_ticks: int = 0
    preempt_loop_limit: int = 8
    stall_ticks: int | None = None
    fault_injector: object | None = None
    host_pages: int | None = None
    evictor: str = "lru"
    host_tier_dtype: str | None = None

    def __post_init__(self):
        if not self.use_fused_prefill:
            _not_ported("the dequantize-gather prefill oracle "
                        "(use_fused_prefill=False)",
                        "ROADMAP queue 1, item 13")
        if self.prefix_cache:
            _not_ported("prefix caching", "ROADMAP queue 1, item 8")
        if (self.host_pages is not None or self.evictor != "lru"
                or self.host_tier_dtype is not None):
            _not_ported("the host swap tier (host_pages / evictor / "
                        "host_tier_dtype)", "ROADMAP queue 1, item 10")
        if (self.watermark is not None or self.aging_ticks
                or self.fault_injector is not None
                or self.stall_ticks is not None):
            _not_ported("overload controls (watermark / aging_ticks / "
                        "fault_injector / stall_ticks)",
                        "ROADMAP queue 1, item 9")
        if not isinstance(self.kv_cache_dtype, str):
            _not_ported("mixed per-layer precision plans",
                        "ROADMAP queue 1, item 11")
        if self.kv_cache_dtype not in KV_DTYPES:
            if self.kv_cache_dtype.endswith(".json"):
                _not_ported("mixed per-layer precision plans",
                            "ROADMAP queue 1, item 11")
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r};"
                             f" expected one of {KV_DTYPES}")
        if self.kv_cache_dtype != "int8" and not self.paged:
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} requires "
                f"paged=True (the contiguous backends are int8-only)")
