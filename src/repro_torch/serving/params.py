"""Request-level sampling parameters and the engine configuration (port
of ``repro.serving.params``).

Field names are the reference's. Options whose machinery is not ported
yet raise `NotImplementedError` naming their ROADMAP item instead of
being silently ignored. `sampling_arrays` compiles a batch of
`SamplingParams` into the per-row arrays the decode paths draw with
(`models.sampling.sample_at_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.quantization import (KV_DTYPES, kv_storage_dtype,
                                           resolve_kv_dtype_spec)
from repro_torch.core.tiering import EVICTORS
from repro_torch.models import prng

# finish reasons a request can end with
FINISH_REASONS = ("stop_token", "stop_string", "length", "aborted")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request settings. ``temperature == 0`` is exact greedy argmax;
    ``top_k`` 0 and ``top_p`` 1.0 disable their filters. ``seed`` fixes
    the request's PRNG stream (token i is drawn with
    ``fold_in(PRNGKey(seed), i)``); None derives it from the request uid.
    ``stop_token_ids`` finish a request when the NEXT token is one of them
    (the stop token itself is not emitted); ``stop`` strings are matched
    against the detokenized generated stream. ``priority``: higher is
    admitted first and preempted last under overload."""
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


def request_key(uid: int, params: SamplingParams) -> np.ndarray:
    """The request's base PRNG key, (2,) uint32: ``PRNGKey(seed)``, the
    seed being the request uid when ``params.seed`` is None."""
    seed = params.seed if params.seed is not None else uid
    return prng.PRNGKey(seed).numpy().astype(np.uint32)


def sampling_arrays(params: Sequence[SamplingParams], *,
                    uids: Sequence[int] | None = None,
                    steps: Sequence[int] | None = None,
                    keys: Sequence[np.ndarray | None] | None = None) -> dict:
    """A batch of `SamplingParams` as per-row numpy arrays: temperature,
    top_k, top_p (B,), key (B, 2) uint32 base keys, step (B,) int32 (the
    index of each row's NEXT token). ``keys`` gives precomputed base keys
    (None entries fall back to `request_key`); greedy rows never draw and
    keep a zero key."""
    B = len(params)
    uids = list(uids) if uids is not None else list(range(B))
    steps = list(steps) if steps is not None else [0] * B
    out = {
        "temperature": np.zeros((B,), np.float32),
        "top_k": np.zeros((B,), np.int32),
        "top_p": np.ones((B,), np.float32),
        "key": np.zeros((B, 2), np.uint32),
        "step": np.asarray(steps, np.int32),
    }
    for i, sp in enumerate(params):
        out["temperature"][i] = sp.temperature
        out["top_k"][i] = sp.top_k
        out["top_p"][i] = sp.top_p
        if not sp.is_greedy:
            pre = keys[i] if keys is not None else None
            out["key"][i] = pre if pre is not None \
                else request_key(uids[i], sp)
    return out


@dataclasses.dataclass
class EngineConfig:
    """One object configuring the serving stack: the reference's field
    names and defaults. Ported: ``batch``, ``max_len``, ``eos_id``,
    ``paged`` (False: the contiguous backend, the default; True: the page
    pool), ``n_pages``, ``chunk``, ``prefix_cache`` and ``prefill_chunk``
    (paged only: the batcher raises ValueError otherwise), ``detokenize``,
    ``kv_cache_dtype`` (anything but int8: paged only) and the overload
    controls: ``watermark`` (paged only: admission reserves the
    prompt's pages plus this many pages of decode headroom instead of the
    worst case, decode grows the reservation and preempts under pressure;
    None keeps the worst case), ``aging_ticks`` (a queued request gains +1
    effective priority per that many ticks waited; 0 is off),
    ``preempt_loop_limit`` (preemptions without progress before
    `PoolExhaustedError`), ``stall_ticks`` (ticks without progress with
    work in flight before `StallError`; None disarms the watchdog) and
    ``fault_injector`` (paged only: a `core.paging.PoolFaultInjector` on
    the page allocator), and the tiered cache: ``host_pages`` (a host swap
    tier of that many pages; needs ``paged`` and ``prefix_cache``, whose
    chain digests are its page handle), ``evictor`` (``"lru"`` or
    ``"freq"``, `core.tiering.EVICTORS`) and ``host_tier_dtype`` (demoted
    pages stored recompressed to that dtype: lossy, so restores are no
    longer bitwise; None keeps the device bytes). ``kv_cache_dtype`` is a
    uniform dtype string or a per-layer precision plan (a
    `core.quantization.PrecisionPlan`, a plan dict, a path to a plan JSON
    or a per-layer dtype sequence), resolved at construction: a plan whose
    layers agree becomes that dtype string (an all-int8 plan is the
    default engine), a mixed one the tuple of per-layer dtypes. It is read
    again every paged tick: a flip on an idle engine rebuilds the pools.
    ``use_fused_prefill=False`` raises `NotImplementedError`."""
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
    stall_ticks: int | None = 500
    fault_injector: object | None = None
    host_pages: int | None = None
    evictor: str = "lru"
    host_tier_dtype: str | None = None

    def __post_init__(self):
        if not self.use_fused_prefill:
            _not_ported("the dequantize-gather prefill oracle "
                        "(use_fused_prefill=False)",
                        "ROADMAP queue 1, item 13")
        # the layer count is checked where the model is known (the batcher)
        self.kv_cache_dtype = resolve_kv_dtype_spec(self.kv_cache_dtype)
        if self.kv_cache_dtype != "int8" and not self.paged:
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} requires "
                f"paged=True (the contiguous backends are int8-only)")
        if self.evictor not in EVICTORS:
            raise ValueError(f"evictor={self.evictor!r} is not a registered "
                             f"policy; expected one of {sorted(EVICTORS)} "
                             f"(DESIGN.md §11)")
        if self.host_pages is not None:
            if self.host_pages < 1:
                raise ValueError(f"host_pages must be >= 1 "
                                 f"(got {self.host_pages})")
            if not (self.paged and self.prefix_cache):
                raise ValueError(
                    "host_pages requires paged=True and prefix_cache=True: "
                    "chain digests are the host tier's page handle "
                    "(DESIGN.md §11)")
        if self.host_tier_dtype is not None:
            kv_storage_dtype(self.host_tier_dtype)   # validates the name
            if self.host_pages is None:
                raise ValueError("host_tier_dtype without host_pages: "
                                 "there is no host tier to recompress for "
                                 "(DESIGN.md §11)")
