"""Host-side continuous-batching scheduler over the quantized cache (port
of ``repro.serving.scheduler``, both backends).

A fixed pool of ``batch`` rows; empty rows refill from the request queue
between device steps, highest effective priority first (FCFS within a
priority).

Contiguous backend (``EngineConfig.paged=False``, the default): the cache
has one length for every row, so a tick that admits requests rebuilds the
batch: every active history (prompt + generated) is left-padded to a
common block multiple and re-prefilled at positions 0..S-1, pad tokens
included. A candidate waits while the rebuilt length plus any row's
remaining budget would overflow ``max_len``.

Paged backend (``paged=True``): admission reserves pages for each request's
UNPADDED prompt plus its decode budget (`pages_for_request`) and feeds the
prompt by varlen chunked prefill: ``prefill_chunk`` tokens per dispatch
(default 4 pages), full chunks page-aligned, the final partial chunk at a
power-of-two page width with a per-row valid length, interleaved tick by
tick with decode so a long prompt never stalls running rows. With
``prefix_cache`` each prompt's full pages are hashed (`chain_hashes`);
admission adopts the resident prefix by refcount (rounded down to a chunk
boundary and never the final chunk, so hit and miss runs chunk alike and
give the same tokens), each chunk's completed pages are published as they
are written, and a released row's fully kept decode pages are published
under the prompt's extended chain. Decode ticks scan up to ``chunk``
tokens per dispatch, never past the smallest remaining budget, rounded
down to a power of two. Stop tokens, the engine ``eos_id`` and stop
strings finish a row; tokens past a mid-chunk stop are discarded (decode
is causal).

Both backends draw per request (`SamplingParams`): token i of a request
with base key k is drawn with ``fold_in(k, i)`` on the card, whether it
comes from prefill logits, a per-token tick or a decode scan, so a seeded
stream does not depend on the batch or the chunking. A dispatch whose
read rows are all greedy takes the plain argmax.

Overload (paged; the reference's logic, counters and messages): with
``EngineConfig.watermark`` set, admission reserves the stream's pages plus
``watermark`` pages of decode headroom instead of the worst case, and a
growth pass before each decode chunk maps every page the chunk can flush
into. When the pool cannot cover the growth, a victim (lowest priority,
then latest arrival; never the last running row) is preempted: its fp
residual and pending token are kept, its pages release through promotion
so they stay hittable, and it re-queues. Re-admission adopts the resident
pages and restores the residual (fast resume, the same tokens as a run
never preempted) or, when pages were reclaimed, re-prefills prompt +
generated with the pending token restored, never redrawn (recompute
resume). Queued requests age (+1 priority per ``aging_ticks``); a
preemption loop without progress raises `PoolExhaustedError` and
``stall_ticks`` ticks without progress raise `StallError`, each with the
per-request state. A seeded `core.paging.PoolFaultInjector` on the
allocator drives these paths.

Tiered cache (paged, ``host_pages`` with the prefix cache): a reclaimed
cached page is first copied to a host tier (pinned host tensors on the
card) under its chain digest; admission promotes a hosted continuation
of a prompt's chain back into device pages before it adopts hits, and a
preempted row's pages are copied to the tier at once (preempt-by-swap),
so a resume whose device pages were reclaimed restores them bit for bit
instead of recomputing. The copies run on CUDA streams in order with the
in-place page writes and make no host sync.

Storage formats (paged): ``kv_cache_dtype`` is one dtype for every layer
or a per-layer precision plan (`core.quantization.resolve_kv_dtype_spec`):
each layer has its own pool at its own dtype, a host record holds each
layer's page in its own format, and a request may name no dtype of its
own under a plan. The spec is read again every tick: a flip (between
dtypes, plans, or the two) on an idle engine rebuilds the pools.

Dispatch (the reference's jitted entries): per-token ticks go through
``_decode``, decode-scan chunks through ``_chunk_fns`` keyed ``(n,
kv_cache_dtype)``, draws at the host boundary through ``_sample_fn`` and
prompt chunks through ``_chunk_prefill_fns`` keyed ``(hist_blocks,
use_fused_prefill, kv_cache_dtype)``. ``_decode``, ``_sample_fn``, the
prompt chunks and ``_scan_step`` (one step of a scan,
`models.transformer.decode_scan_step`, which an n-step chunk calls n
times) are each a `serving.dispatch.Step`:
on the card, with the paged backend, one captured CUDA graph per shape
key, replayed; on the CPU and on the contiguous backend, the eager
function. So a chunk's length never shapes a graph: a scan of any length
replays the same step. The paged state's tensors and the step inputs
(`_Inputs`) keep their addresses until the state is rebuilt, which starts
a new graph generation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import tiering as TIER
from repro_torch.core.paging import (SENTINEL_PAGE, HostPageAllocator,
                                     _as_bytes, chain_hashes,
                                     live_page_count, page_bytes_for)
from repro_torch.core import quantization as Q
from repro_torch.models import sampling as SMP
from repro_torch.models import transformer as T
from repro_torch.runtime.fault import StallWatchdog
from repro_torch.serving.dispatch import GraphDispatch
from repro_torch.serving.engine import (check_encdec, check_one_device,
                                        make_chunk_prefill_fn, make_serve_fns)
from repro_torch.serving.params import (EngineConfig, SamplingParams,
                                        default_detokenize, request_key,
                                        sampling_arrays)


class PoolExhaustedError(RuntimeError):
    """The scheduler preempted ``EngineConfig.preempt_loop_limit`` times
    without any request advancing: the pool cannot serve the committed
    working set. The message lists every page holder (uid -> pages), the
    pool and the per-request state."""


class StallError(RuntimeError):
    """No request advanced for ``EngineConfig.stall_ticks`` consecutive
    ticks with work in flight; carries the per-request state (queued,
    preempted, mid-prefill cursor, decoding position) and the pool's."""


class _Inputs:
    """The step functions' tensor inputs, persistent on the batcher's
    device and refilled before each dispatch (`ContinuousBatcher._upload`):
    the pending token, positions and row mask, the per-row sampling
    arrays, the decode scan's carry (`models.transformer.scan_carry` of
    up to ``max_len`` steps, whose ``tok`` and ``pos`` are these), the
    chunk prefill's tokens (one buffer per dispatch width), starts, valid
    counts and mask; paged, the page table every layer shares (no step
    writes it) and the lengths `_sync_device` copies into each layer's
    own. They live with the paged state, so a flip frees them with the
    pools."""

    def __init__(self, batch: int, max_len: int, max_blocks: int | None,
                 device):
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        self.carry = T.scan_carry(z((batch, 1), torch.int32),
                                  z((batch,), torch.int32), max_len)
        self.tok, self.pos = self.carry["tok"], self.carry["pos"]
        self.mask = z((batch,), torch.bool)
        self.sampling = {"temperature": z((batch,), torch.float32),
                         "top_k": z((batch,), torch.int32),
                         "top_p": z((batch,), torch.float32),
                         "key": z((batch, 2), torch.int64),
                         "step": z((batch,), torch.int32)}
        self.start = z((batch,), torch.int32)
        self.valid = z((batch,), torch.int32)
        self.pf_mask = z((batch,), torch.bool)
        self.tokens: dict[int, torch.Tensor] = {}
        self.table = self.length = None
        if max_blocks is not None:
            self.table = z((batch, max_blocks), torch.int32)
            self.length = z((batch,), torch.int32)

    def chunk_tokens(self, width: int) -> torch.Tensor:
        t = self.tokens.get(width)
        if t is None:
            t = self.tokens[width] = torch.zeros(
                (self.tok.shape[0], width), dtype=torch.int32,
                device=self.tok.device)
        return t


def _scan_step(cfg, params, state, carry, row_mask, sampling):
    """`models.transformer.decode_scan_step` in a step's argument order
    (weights, state, then the tensor inputs)."""
    return T.decode_scan_step(params, cfg, state, carry, row_mask=row_mask,
                              sampling=sampling)


def pages_for_request(prompt_len: int, max_new: int, page_size: int) -> int:
    """Pages one request reserves: its unpadded prompt plus the full decode
    budget, rounded up to whole pages."""
    return -(-(max(prompt_len, 1) + max_new) // page_size)


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record: prompt (S,) int32,
    a decode budget (None = ``sampling.max_new_tokens``), and the decoded
    output in ``generated``. ``finish_reason`` is one of
    `serving.params.FINISH_REASONS`; timestamps are `time.perf_counter`
    seconds. ``priority`` None takes ``sampling.priority`` at submit."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int | None = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams.greedy)
    priority: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None
    submit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None


class ContinuousBatcher:
    """Continuous batching over ``config.batch`` rows on ``device``
    (default "cuda"; raises when there is no card). `submit` queues
    requests; `step` runs one tick (admit, prefill — a rebuild of the
    batch, or one paged chunk — and one decode chunk); `abort` cancels a
    queued or running uid; `run_to_completion` drains the queue."""

    def __init__(self, params, cfg, config: EngineConfig, *, device="cuda"):
        check_one_device("the batchers")
        self.device = T.check_device(device)
        if cfg.family == "encdec" and config.paged:
            check_encdec(True, config.kv_cache_dtype)
        T.check_servable(cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"batcher on {self.device}")
        self.paged = config.paged
        if self.paged and cfg.quant.granularity != "per_block":
            raise ValueError("paged serving requires per_block quantization")
        if (config.prefix_cache or config.prefill_chunk is not None) \
                and not self.paged:
            raise ValueError("prefix caching / chunked prefill require the "
                             "paged backend (paged=True)")
        if (config.watermark is not None
                or config.fault_injector is not None) and not self.paged:
            raise ValueError("watermark admission / pool fault injection "
                             "require the paged backend (paged=True)")
        if config.watermark is not None and config.watermark < 0:
            raise ValueError(f"watermark must be >= 0 "
                             f"(got {config.watermark})")
        self.watermark = config.watermark
        self.aging_ticks = int(config.aging_ticks or 0)
        self.preempt_loop_limit = config.preempt_loop_limit
        self._watchdog = StallWatchdog(config.stall_ticks)
        self._seq = 0               # arrival order: the FCFS tie-break
        self._progressed = False
        self._preempts_since_progress = 0
        self.preemptions = 0
        self.preempt_fast_resumes = 0
        self.preempt_recompute_resumes = 0
        self.decode_stall_ticks = 0
        # the tiered cache: host tier, cost model, uid -> pages in flight of
        # a swap-waiting request; inert without host_pages
        self._tiering = None
        self._swap_cost = None
        self._swap_wait: dict[int, int] = {}
        self.preempt_by_swap = 0
        self.preempt_swap_restores = 0
        # reclaim victims waiting for their batched device-to-host copy;
        # promoted pages in flight -> (copy's event, records); the side
        # stream of promotions (card only)
        self._demote_queue: list[tuple[int, bytes]] = []
        self._promo_events: dict[int, tuple] = {}
        self._copy_stream = None
        self._host_slab = None
        self.prefix_cache = bool(config.prefix_cache)
        self.config = config
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = config.batch, config.max_len
        self.eos_id = config.eos_id
        self.chunk = config.chunk
        self.detokenize = config.detokenize or default_detokenize
        self._inflight_uids: set[int] = set()
        self.aborted_requests = 0
        self._ttfts: list[float] = []
        self.ticks = 0
        self.prefill_tokens_computed = 0
        self.decode_tokens_computed = 0
        self.block = (cfg.quant.block_size
                      if cfg.quant.granularity == "per_block" else 8)
        self.n_pages = None
        # the pools' storage format (a dtype string, or a tuple of one per
        # layer under a mixed plan); config.kv_cache_dtype is the wanted
        # one, the two differ between a flip and the next paged tick
        self.kv_cache_dtype = self._want_dtype_spec()
        if self.paged:
            self.page_size = cfg.quant.block_size
            self.max_blocks = self.max_len // self.page_size
            self.n_pages = (config.n_pages if config.n_pages is not None
                            else self.batch * self.max_blocks + 1)
            if config.host_pages is not None:
                self._swap_cost = TIER.SwapCostModel(self.page_size)
            self._new_allocator()
            self.tables = np.zeros((self.batch, self.max_blocks), np.int32)
            self.row_pages: list[list[int]] = [[] for _ in range(self.batch)]
            # preemption: uid -> snapshot (pending token, fp residual, full
            # token stream and its hash chain); per row, where this
            # residency's decoding starts in `generated`, and the pending
            # token a recompute resume restores instead of drawing
            self._suspended: dict[int, dict] = {}
            self.gen_base = [0] * self.batch
            self._resume_tok: dict[int, int] = {}
            # uid -> (toks, chain) of a head blocked on the pool, hashed once
            self._admit_memo: dict[int, tuple] = {}
            # per row: the unpadded prompt and the hash chain of its full
            # pages, kept until release for decode-page promotion
            self.streams: list[np.ndarray | None] = [None] * self.batch
            self.row_chain: list[list[bytes] | None] = [None] * self.batch
            # copy-on-write scan before decode, armed only by a caller that
            # shares flush targets between rows (`fork_row`): the
            # scheduler's own decode flushes only private pages
            self.cow_armed = False
            pc = config.prefill_chunk or 4 * self.page_size
            self.prefill_chunk_tokens = -(-pc // self.page_size) * \
                self.page_size
            # (hist_blocks, use_fused_prefill, kv dtype spec) -> chunk step
            self._chunk_prefill_fns: dict[tuple, object] = {}
            self.prefilling: dict[int, dict] = {}   # row -> toks/cursor/S
            self._pf_rr = 0
        # the compiled dispatch: graphs on the card for the paged backend
        # (the contiguous cache keeps its length on the host: eager)
        self._dispatch = GraphDispatch(
            self.device, enabled=self.paged and self._on_card())
        # (steps, kv dtype spec) -> decode-scan chunk step
        self._chunk_fns: dict[tuple, object] = {}
        self._sample_fn = self._dispatch.step(
            functools.partial(SMP.sample_at_step, vocab=cfg.vocab),
            name="sample", copy_in=(0,))
        self._make_serve_fns()
        self._inputs: _Inputs | None = None
        self.queue: deque[Request] = deque()
        self.rows: list[Request | None] = [None] * self.batch
        self.pos = np.zeros((self.batch,), np.int32)
        self.tok = np.zeros((self.batch, 1), np.int32)
        self.state = None

    def _make_serve_fns(self):
        """The state initializer, the contiguous prefill and the per-token
        decode step for the current storage format (the reference jits
        the last two again at a flip)."""
        self._init_state, self._prefill, decode = make_serve_fns(
            self.cfg, max_len=self.max_len, paged=self.paged,
            n_pages=self.n_pages, kv_cache_dtype=self.kv_cache_dtype,
            device=self.device)
        self._decode = self._dispatch.step(decode, name="decode",
                                           opaque=(0, 2), state_arg=2)
        self._scan_step = self._dispatch.step(
            functools.partial(_scan_step, self.cfg), name="decode_scan_step",
            opaque=(0, 1), state_arg=1)
        # what a capture's warm-up runs on: a paged state of the live one's
        # structure (batch, table width, per-layer dtypes) over 2 pages
        self._dispatch.scratch = functools.partial(
            T.init_decode_state, self.cfg, self.batch, self.max_len,
            paged=True, n_pages=2, kv_cache_dtype=self.kv_cache_dtype,
            device=self.device)

    def _new_state(self) -> list:
        """A fresh paged state and its step inputs; every layer reads the
        inputs' page table."""
        state = self._init_state(self.batch)
        self._inputs = _Inputs(self.batch, self.max_len, self.max_blocks,
                              self.device)
        for c in state:
            c.page_table = self._inputs.table
        return state

    def _bufs(self) -> _Inputs:
        if self._inputs is None:          # contiguous: no table, no lengths
            self._inputs = _Inputs(self.batch, self.max_len, None,
                                  self.device)
        return self._inputs

    def _upload(self, dst: torch.Tensor, a) -> torch.Tensor:
        """Copy host array ``a`` into the persistent tensor ``dst``, in
        order on the current stream. On the card through a pinned block
        of the caching host allocator, which keeps the block until the
        copy has landed, so the next tick's upload never rewrites bytes
        still in flight: no host sync."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        if self._on_card():
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)
        return dst

    def _layer_dtypes(self) -> tuple[str, ...]:
        """The pools' dtype, one per layer."""
        return Q.layer_kv_dtypes(self.kv_cache_dtype, self.cfg.n_layers)

    def _new_allocator(self):
        """A fresh allocator and, with ``host_pages``, an empty host tier
        and its host slab (pinned on the card, allocated here once), wired
        to the demotion hooks. A slot holds one page of every layer: the
        values as one run of bytes, layer after layer, each in its host
        dtype (``host_tier_dtype``, else the layer's own; an int4 layer
        takes half the bytes), and the float32 scales (L, 2, H_kv, D);
        ``_host_layout`` gives each layer's (offset, bytes, host dtype)."""
        c = self.config
        if c.host_pages is not None:
            self._tiering = TIER.HostTier(c.host_pages,
                                          dtype=c.host_tier_dtype)
            m = self.cfg
            self._host_layout, off = [], 0
            for dt in self._layer_dtypes():
                hd = c.host_tier_dtype or dt
                n = 2 * Q.packed_tokens(self.page_size, hd) * m.n_kv_heads \
                    * m.head_dim
                self._host_layout.append((off, n, hd))
                off += n
            self._host_slab = TIER.HostSlab(
                c.host_pages, (off,),
                (m.n_layers, 2, m.n_kv_heads, m.head_dim), device=self.device)
            self._tiering.on_remove = self._host_slab.release
        self.allocator = HostPageAllocator(
            self.n_pages, prefix_cache=self.prefix_cache,
            injector=c.fault_injector, evictor=c.evictor,
            host_tier=self._tiering)
        if self._tiering is not None:
            self.allocator.demote_hook = self._queue_demotion
            self.allocator.demote_flush = self._flush_demotions

    def _want_dtype_spec(self):
        """The storage format ``config.kv_cache_dtype`` asks for now (a
        live field, resolved as at construction): a dtype string, or the
        tuple of per-layer dtypes of a mixed plan, whose length must be
        the model's layer count."""
        return Q.resolve_kv_dtype_spec(
            getattr(self.config, "kv_cache_dtype", "int8"),
            n_layers=self.cfg.n_layers)

    def submit(self, req: Request):
        """Queue a request. Every check runs before any state changes, so a
        rejected request leaves the batcher and the request as they were.
        The worst-case page count is checked against the whole pool even
        under a watermark: a request that fits alone lets the last running
        row always grow to its budget."""
        if req.uid in self._inflight_uids:
            raise ValueError(f"request uid {req.uid} is already in flight "
                             f"(queued or running); uids are the lifecycle "
                             f"handle and must be unique until completion")
        want, engine = req.sampling.kv_cache_dtype, self._want_dtype_spec()
        if want is not None and want != engine:
            if isinstance(engine, str):
                raise ValueError(
                    f"request {req.uid}: kv_cache_dtype={want!r} does "
                    f"not match the engine's pool backend "
                    f"({engine!r}); the pool carries ONE storage "
                    f"format — flip EngineConfig.kv_cache_dtype on an idle "
                    f"engine instead (DESIGN.md §9)")
            raise ValueError(
                f"request {req.uid}: kv_cache_dtype={want!r} "
                f"contradicts the engine's mixed per-layer precision plan "
                f"({'/'.join(engine)}); plan-driven engines accept "
                f"only requests with kv_cache_dtype=None — the plan, not "
                f"the request, owns layer precision (DESIGN.md §10)")
        budget = (req.max_new_tokens if req.max_new_tokens is not None
                  else req.sampling.max_new_tokens)
        if self.paged:
            if len(req.prompt) < 1:
                raise ValueError(f"request {req.uid}: empty prompt")
            if len(req.prompt) + budget > self.max_len:
                raise ValueError(f"request {req.uid}: prompt+max_new exceeds "
                                 f"max_len={self.max_len}")
            if pages_for_request(len(req.prompt), budget,
                                 self.page_size) > self.n_pages - 1:
                raise ValueError(f"request {req.uid} needs more pages than "
                                 f"the pool holds ({self.n_pages - 1}); "
                                 f"raise n_pages")
        elif self._pad(len(req.prompt)) + budget > self.max_len:
            raise ValueError(f"request {req.uid}: prompt+max_new exceeds "
                             f"max_len={self.max_len}")
        req.max_new_tokens = budget
        if req.priority is None:
            req.priority = req.sampling.priority
        req.submit_time = time.perf_counter()
        req._submit_tick = self.ticks       # the aging clock
        req._arrival = self._seq            # the FCFS tie-break
        self._seq += 1
        self._inflight_uids.add(req.uid)
        self.queue.append(req)

    def _pad(self, n: int) -> int:
        """``n`` tokens rounded up to the block (the contiguous prefill
        length; at least one block)."""
        return -(-max(n, 1) // self.block) * self.block

    # -- priorities and aging ------------------------------------------------
    def _queue_priority(self, r: Request) -> int:
        """A queued request's effective priority: its own plus one per
        ``aging_ticks`` waited (running rows do not age)."""
        p = r.priority if r.priority is not None else 0
        if self.aging_ticks:
            p += (self.ticks - getattr(r, "_submit_tick", self.ticks)) \
                // self.aging_ticks
        return p

    def _next_candidate_index(self) -> int:
        """Queue index of the next admission candidate: highest effective
        priority, then arrival. A head blocked on the pool does not yield
        to a smaller later request (that would starve it again)."""
        return min(range(len(self.queue)),
                   key=lambda k: (-self._queue_priority(self.queue[k]),
                                  getattr(self.queue[k], "_arrival", k)))

    # -- per-request sampling ------------------------------------------------
    def _req_key(self, r: Request) -> np.ndarray:
        """The request's base key, derived once and kept on the request."""
        k = getattr(r, "_base_key", None)
        if k is None:
            k = r._base_key = request_key(r.uid, r.sampling)
        return k

    def _needs_sampling(self, idxs) -> bool:
        """True when a row whose draw is read samples (a sampled row still
        mid-prefill does not take greedy decoders off the argmax)."""
        return any(self.rows[i] is not None
                   and not self.rows[i].sampling.is_greedy for i in idxs)

    def _sampling_arrays(self, offset: int) -> dict:
        """Per-row sampling tensors for the whole batch (empty rows
        greedy), uploaded into the persistent buffers. Each row's next
        token index is its generated count plus ``offset``: 0 for the
        first token from prefill logits, 1 in decode (the pending token
        holds index len(generated))."""
        sps, keys, steps = [], [], []
        for r in self.rows:
            sps.append(r.sampling if r is not None
                       else SamplingParams.greedy())
            keys.append(self._req_key(r)
                        if r is not None and not r.sampling.is_greedy
                        else None)
            steps.append((len(r.generated) if r is not None else 0) + offset)
        arrays = sampling_arrays(sps, steps=steps, keys=keys)
        arrays["key"] = arrays["key"].astype(np.int64)
        out = self._bufs().sampling
        for k, t in out.items():
            self._upload(t, arrays[k])
        return out

    def _draw(self, logits, idxs, *, offset: int) -> torch.Tensor:
        """Next token of every row on the device, honouring each request's
        parameters (the decode scan's draw, at the host boundary, through
        ``_sample_fn``); ``idxs`` are the rows whose draw the caller
        reads."""
        if not self._needs_sampling(idxs):
            return SMP.greedy(logits, self.cfg.vocab)
        s = self._sampling_arrays(offset)
        return self._sample_fn(logits, s["temperature"], s["top_k"],
                               s["top_p"], s["key"], s["step"])

    def _sample_rows(self, logits, idxs, *, offset: int) -> np.ndarray:
        """`_draw`, read on the host."""
        return self._draw(logits, idxs, offset=offset).cpu().numpy()

    # -- lifecycle helpers -------------------------------------------------
    def _record_first_token(self, r: Request):
        if r.first_token_time is None:
            r.first_token_time = time.perf_counter()
            if r.submit_time is not None:
                self._ttfts.append(r.first_token_time - r.submit_time)

    def _finish(self, r: Request, reason: str):
        r.done = True
        r.finish_reason = reason
        r.finish_time = time.perf_counter()
        self._inflight_uids.discard(r.uid)

    def _stop_ids(self, r: Request) -> frozenset:
        ids = frozenset(r.sampling.stop_token_ids)
        return ids | {self.eos_id} if self.eos_id is not None else ids

    def _stop_string_hit(self, r: Request) -> bool:
        """True when the detokenized generated stream ends in one of the
        request's stop strings. Only a ``max(len(stop))``-token suffix is
        scanned, which assumes every token renders to >= 1 character."""
        stops = r.sampling.stop
        if not stops:
            return False
        window = max(len(s) for s in stops)
        text = self.detokenize(r.generated[-window:])
        return any(s in text for s in stops)

    def _check_stop(self, r: Request, nxt: int) -> str | None:
        """Finish reason after appending a token, given the next (sampled,
        not yet fed) token: a stop string, then the budget, then a stop
        token about to be emitted (which is suppressed)."""
        if self._stop_string_hit(r):
            return "stop_string"
        if len(r.generated) >= r.max_new_tokens:
            return "length"
        if int(nxt) in self._stop_ids(r):
            return "stop_token"
        return None

    def abort(self, uid: int) -> Request | None:
        """Cancel a queued or running request; returns it marked
        ``finish_reason="aborted"``, or None if ``uid`` is not in flight."""
        for idx, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[idx]
                if self.paged:
                    self._admit_memo.pop(uid, None)
                    self._suspended.pop(uid, None)
                    self._swap_wait.pop(uid, None)
                self._finish(r, "aborted")
                self.aborted_requests += 1
                return r
        for i, r in enumerate(self.rows):
            if r is not None and r.uid == uid:
                self._finish(r, "aborted")
                self._release_row(i)
                if self.paged:
                    self._sync_device()
                self.aborted_requests += 1
                return r
        return None

    def lifecycle_report(self) -> dict:
        ts = np.asarray(self._ttfts, np.float64)
        pct = (lambda q: float(np.percentile(ts, q))) if ts.size else \
            (lambda q: 0.0)
        return {"aborted_requests": self.aborted_requests,
                "ttft_s_p50": pct(50), "ttft_s_p90": pct(90),
                "ttft_s_p99": pct(99)}

    def step(self) -> list[Request]:
        """One scheduler tick: admit, prefill (a rebuild of the batch, or
        one paged chunk), decode one chunk for the rows past prefill.
        Returns requests finished now. Raises `StallError` when no request
        advanced for ``stall_ticks`` ticks with work in flight."""
        self.ticks += 1
        self._progressed = False
        self._ensure_backend_dtype()
        done = self._step_paged() if self.paged else self._step_contiguous()
        if done:
            self._progressed = True
        if self._progressed:
            self._preempts_since_progress = 0
        busy = bool(self.queue) or any(r is not None for r in self.rows)
        if self._watchdog.observe(self._progressed, busy):
            raise StallError(
                f"scheduler stalled: no request advanced in "
                f"{self._watchdog.limit} consecutive ticks with work in "
                f"flight; {self._stuck_report()}")
        return done

    def _stuck_report(self) -> str:
        """Per-request state (queued, preempted, mid-prefill cursor,
        decoding position) and the pool's occupancy and injector counters,
        for `StallError` and `run_to_completion`."""
        parts = []
        for r in self.queue:
            tag = ("queued(preempted)" if self.paged
                   and r.uid in self._suspended else "queued")
            if self.paged and r.uid in self._swap_wait:
                tag += (f" swap-wait:{self._swap_wait[r.uid]} "
                        f"page(s) in flight")
            parts.append(f"uid {r.uid}: {tag}")
        for i, r in enumerate(self.rows):
            if r is None:
                continue
            if self.paged and i in self.prefilling:
                st = self.prefilling[i]
                parts.append(f"uid {r.uid}: mid-prefill "
                             f"{st['cursor']}/{st['S']}")
            else:
                parts.append(f"uid {r.uid}: decoding pos={int(self.pos[i])} "
                             f"generated={len(r.generated)}")
        rep = "per-request state: [" + "; ".join(parts) + "]"
        if self.paged:
            a = self.allocator
            rep += (f"; pool: available={a.available} free={a.n_free} "
                    f"cached={a.n_cached} preemptions={self.preemptions}")
            if self._tiering is not None:
                rep += (f"; host tier: hosted={len(self._tiering)} "
                        f"inflight={len(a.inflight)}")
            if a.injector is not None:
                rep += (f"; injector: fault_ticks="
                        f"{a.injector.alloc_fault_ticks} "
                        f"held={a.injector.hold_pages} "
                        f"deferred={len(a.deferred)} "
                        f"swap_faults={a.injector.swap_faults}")
        return rep

    def _ensure_backend_dtype(self):
        """Honour a live flip of ``config.kv_cache_dtype`` (a dtype or a
        per-layer plan, either way). The storage format is in every page
        and index entry, so the flip cannot happen in place: on a tick
        with nothing resident (no row, no prefill, no preemption snapshot)
        the pools, the allocator, the host tier and the per-row tables are
        rebuilt empty for the new spec (the old pools are dropped, so their
        device memory goes back); queued requests hold no pages and ride
        the rebuild. Anything resident raises: re-quantizing live pages
        would corrupt their streams."""
        want = self._want_dtype_spec()
        if want == self.kv_cache_dtype:
            return
        if not self.paged:
            raise RuntimeError(
                f"kv_cache_dtype={want!r} requires the paged backend")
        if (any(r is not None for r in self.rows) or self.prefilling
                or self._suspended):
            raise RuntimeError(
                f"cannot flip kv_cache_dtype to {want!r} with rows "
                f"resident in the pool; drain the engine first "
                f"(DESIGN.md §9, §10)")
        self.kv_cache_dtype = want
        self.state = None                      # rebuilt next tick
        self._inputs = None
        # the graphs point into the old state: dropped, never replayed;
        # the keys stay, as the reference's trace caches do
        self._dispatch.new_generation()
        self._make_serve_fns()
        self._demote_queue.clear()
        self._promo_events.clear()
        self._new_allocator()
        self._swap_wait.clear()
        self.tables[:] = 0
        self.row_pages = [[] for _ in range(self.batch)]
        self.streams = [None] * self.batch
        self.row_chain = [None] * self.batch
        self.gen_base = [0] * self.batch
        self._suspended.clear()
        self._admit_memo.clear()
        self._resume_tok.clear()

    def run_to_completion(self, max_ticks: int = 10_000) -> list[Request]:
        """Drain the queue; returns the requests that finished. Raises
        RuntimeError with the per-request state when ``max_ticks`` runs out
        with requests in flight."""
        out = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.rows):
                return out
        stranded = sorted([r.uid for r in self.queue] +
                          [r.uid for r in self.rows if r is not None])
        raise RuntimeError(
            f"run_to_completion: max_ticks={max_ticks} exhausted with "
            f"{len(stranded)} request(s) still in flight (uids {stranded}); "
            f"{self._stuck_report()}; raise max_ticks or check for an "
            f"admission deadlock")

    # -- decode ------------------------------------------------------------
    _EOS_CHUNK_CAP = 8

    def _chunk_len(self, active: list[int]) -> int:
        """Decode steps this tick: the smallest remaining budget among
        active rows (capped by ``chunk``, and by 8 when any stop condition
        is set and ``chunk`` is None), rounded down to a power of two."""
        rem = min(self.rows[i].max_new_tokens - len(self.rows[i].generated)
                  for i in active)
        n = rem if self.chunk is None else min(self.chunk, rem)
        stops_possible = self.eos_id is not None or any(
            self.rows[i].sampling.stop_token_ids or self.rows[i].sampling.stop
            for i in active)
        if stops_possible and self.chunk is None:
            n = min(n, self._EOS_CHUNK_CAP)
        n = max(n, 1)
        return 1 << (n.bit_length() - 1)

    def _finish_tick(self, active: list[int], nxt: np.ndarray
                     ) -> list[Request]:
        done = []
        for i in active:
            r = self.rows[i]
            r.generated.append(int(self.tok[i, 0]))
            self.tok[i, 0] = nxt[i]
            self.pos[i] += 1
            reason = self._check_stop(r, int(nxt[i]))
            if reason is not None:
                self._finish(r, reason)
                done.append(r)
                self._release_row(i)
        return done

    def _finish_chunk(self, active: list[int], toks: np.ndarray,
                      pending: np.ndarray) -> list[Request]:
        """Bookkeeping after an n-step scan: ``toks`` (n, B) tokens fed at
        each step, ``pending`` (B, 1) the next not-yet-fed token."""
        n = toks.shape[0]
        done = []
        for i in active:
            r = self.rows[i]
            finished = False
            for j in range(n):
                r.generated.append(int(toks[j, i]))
                nxt = toks[j + 1, i] if j + 1 < n else pending[i, 0]
                reason = self._check_stop(r, int(nxt))
                if reason is not None:
                    self._finish(r, reason)
                    finished = True
                    done.append(r)
                    self._release_row(i)
                    break
            if not finished:
                self.tok[i, 0] = pending[i, 0]
                self.pos[i] += n
        return done

    def _decode_tick(self, active: list[int],
                     row_mask: np.ndarray | None = None,
                     n: int | None = None) -> list[Request]:
        """Decode one chunk for the active rows (all rows advance in the
        contiguous cache; paged rows outside ``row_mask`` stay frozen).
        ``n`` is the chunk length the growth pass sized pages for (None:
        `_chunk_len`)."""
        if n is None:
            n = self._chunk_len(active)
        self._progressed = True
        self.decode_tokens_computed += n * len(active)
        if self.paged and self.cow_armed and self._cow_retarget(active, n):
            self._sync_device()          # retargeted tables before the scan
        out = self._launch_decode(active, row_mask, n)
        if n == 1:
            return self._finish_tick(active, out.cpu().numpy())
        pending, toks = out
        return self._finish_chunk(active, toks.cpu().numpy(),
                                  pending.cpu().numpy())

    def _launch_decode(self, active: list[int], row_mask, n: int):
        """Enqueue one decode chunk of ``n`` steps, reading nothing back:
        the uploads into the persistent inputs, then ``_decode`` and the
        draw (n == 1) or the n-step scan (`_chunk_fn`). Returns the draws
        (B,) on the device (n == 1), else (pending (B, 1), emitted (n, B))
        in the persistent buffers, valid until the next dispatch."""
        b = self._bufs()
        tok, pos = self._upload(b.tok, self.tok), self._upload(b.pos, self.pos)
        mask = None if row_mask is None else self._upload(b.mask, row_mask)
        if n == 1:
            logits, self.state = self._decode(self.params, tok, self.state,
                                              pos, mask)
            return self._draw(logits, active, offset=1)
        sampling = (self._sampling_arrays(1)
                    if self._needs_sampling(active) else None)
        self.state = self._chunk_fn(n)(self.params, self.state, mask,
                                       sampling)
        return b.tok, b.carry["emitted"][:n]

    def _chunk_fn(self, n: int):
        """The n-step decode scan, keyed ``(n, kv_cache_dtype)`` as the
        reference's jitted chunk fns (one entry per storage format, and a
        flip back finds its key): n calls of ``_scan_step`` on the
        persistent carry, so every length replays the same graph, and a
        flip, which rebuilds ``_scan_step``, never serves another
        format's."""
        key = (n, self.kv_cache_dtype)
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = self._chunk_fns[key] = functools.partial(self._scan, n)
        return fn

    def _scan(self, n: int, params, state, row_mask, sampling):
        """``n`` steps of the decode scan from the uploaded ``tok`` and
        ``pos``: the carry's step index is reset, then each step is one
        call (on the card, one replay) of ``_scan_step``."""
        carry = self._inputs.carry
        carry["j"].zero_()
        for _ in range(n):
            state = self._scan_step(params, state, carry, row_mask, sampling)
        return state

    def _release_row(self, i: int):
        """Free row ``i``. Paged: with the prefix cache its fully kept
        decode pages are first published (`_promote_on_release`); then each
        page drops one reference — pages still shared survive, indexed
        ones park on the LRU, the rest are free. The device table and
        length stay stale until the next `_sync_device` (before any page is
        handed out again); the dead row's output is discarded."""
        if self.paged and self.prefix_cache:
            self._promote_on_release(i)
        self.rows[i] = None
        self.pos[i] = 0
        self.tok[i, 0] = 0
        if self.paged:
            self.allocator.release(self.row_pages[i])
            self.row_pages[i] = []
            self.tables[i, :] = 0
            self.prefilling.pop(i, None)
            self.streams[i] = None
            self.row_chain[i] = None
            self.gen_base[i] = 0
            self._resume_tok.pop(i, None)

    def _promote_on_release(self, i: int):
        """Publish a finishing row's decode pages under its prompt's chain
        extended over the generated tokens, so a prompt that continues the
        conversation (prompt + completion + a new turn) hits them. The
        extension starts at the prompt's partial tail, and only pages whose
        tokens were all kept are published (not ones reaching past a
        mid-scan stop). A resumed row's stream already holds the tokens
        generated before its preemption, so its extension starts at
        ``gen_base``."""
        r, stream, chain = self.rows[i], self.streams[i], self.row_chain[i]
        if r is None or stream is None:
            return
        ps = self.page_size
        gb = self.gen_base[i]
        S, nb = len(stream), len(stream) // ps
        kept = S + len(r.generated) - gb
        if kept // ps <= nb:
            return
        ext = np.concatenate([stream[nb * ps:],
                              np.asarray(r.generated[gb:], np.int32)])
        ext = ext[:(kept // ps) * ps - nb * ps]
        parent = chain[-1] if chain else None
        for j, h in enumerate(chain_hashes(ext, ps, parent=parent)):
            self.allocator.register(int(self.tables[i, nb + j]), h)

    def _sync_device(self):
        """Push the host page tables and per-row lengths (active rows:
        ``pos``; free rows: 0) into every layer's cache, and the free
        count into each pool's host mirror."""
        lengths = np.where(np.asarray([r is not None for r in self.rows]),
                           self.pos, 0).astype(np.int32)
        b = self._inputs
        self._upload(b.table, self.tables)
        self._upload(b.length, lengths)
        for c in self.state:
            c.length.copy_(b.length)
            c.pool.n_free = self.allocator.n_free

    # -- contiguous backend --------------------------------------------------
    def _admit_rows(self) -> list[int]:
        """Fill empty rows in priority order (`_next_candidate_index`),
        deferring a candidate whose admission would overflow the cache
        after the rebuild: the rebuild restarts every active row at the
        group's padded history length S, so each row's S plus remaining
        budget must fit max_len."""
        active = [r for r in self.rows if r is not None]
        new: list[int] = []
        free = [i for i in range(self.batch) if self.rows[i] is None]
        while free[len(new):] and self.queue:
            k = self._next_candidate_index()
            cand = self.queue[k]
            group = active + [self.rows[i] for i in new] + [cand]
            S = self._pad(max(len(r.prompt) + len(r.generated)
                              for r in group))
            if any(S + r.max_new_tokens - len(r.generated) > self.max_len
                   for r in group):
                break                          # wait until rows free up
            i = free[len(new)]
            del self.queue[k]
            self.rows[i] = cand
            new.append(i)
        if new:
            self._progressed = True
        return new

    def _step_contiguous(self) -> list[Request]:
        newly = self._admit_rows()
        active = [i for i, r in enumerate(self.rows) if r is not None]
        done: list[Request] = []           # first-draw-is-stop completions
        if not active:
            return done
        if newly:
            # rebuild: re-prefill every active history (prompt + generated)
            # left-padded to one block multiple, at positions 0..S-1 with
            # the pad tokens included, as the reference does
            self.state = self._init_state(self.batch)
            hist = {i: np.concatenate(
                [self.rows[i].prompt,
                 np.asarray(self.rows[i].generated, np.int32)])
                for i in active}
            S = self._pad(max(len(h) for h in hist.values()))
            toks = np.zeros((self.batch, S), np.int32)
            for i, h in hist.items():
                toks[i, S - len(h):] = h       # left-pad
            logits, self.state = self._prefill(
                self.params, torch.as_tensor(toks, device=self.device),
                self.state)
            nxt = self._sample_rows(logits, active, offset=0)
            for i in active:
                r = self.rows[i]
                if not r.generated and int(nxt[i]) in self._stop_ids(r):
                    self._finish(r, "stop_token")   # suppressed, empty
                    done.append(r)
                    self._release_row(i)
                    continue
                self.tok[i, 0] = nxt[i]
                self.pos[i] = S
                if not r.generated:
                    self._record_first_token(r)
            active = [i for i in active if self.rows[i] is not None]
        if not active:
            return done
        return done + self._decode_tick(active)

    # -- varlen chunked admission --------------------------------------------
    def _cap_hits(self, match_pages: int, prompt_len: int) -> int:
        """Usable hit length in tokens for a prompt of ``prompt_len``
        tokens whose full pages match ``match_pages`` deep: rounded down to
        a chunk boundary (the rest then chunks as a miss run does, which
        keeps hit and miss tokens equal) and below the final chunk (which
        always computes: the first token is drawn from its logits)."""
        cp = self.prefill_chunk_tokens
        n_chunks = -(-prompt_len // cp)
        hit_chunks = min(match_pages // (cp // self.page_size), n_chunks - 1)
        return max(hit_chunks, 0) * cp

    def _initial_pages(self, stream_len: int, max_new: int) -> int:
        """Pages reserved at admission: the worst case
        (`pages_for_request`) without a watermark; with one, the stream's
        own pages plus ``watermark`` pages of decode headroom (never more
        than the worst case)."""
        total = pages_for_request(stream_len, max_new, self.page_size)
        if self.watermark is None:
            return total
        return min(total,
                   -(-max(stream_len, 1) // self.page_size) + self.watermark)

    def _admit_chunked(self) -> bool:
        """Admit queued requests into free rows in priority order
        (`_next_candidate_index`; a blocked head waits, no bypass). Each
        hashes its prompt's full pages, adopts the resident prefix
        (`_cap_hits`) by refcount, allocates the rest of its reservation
        (`_initial_pages`; cached pages reclaimed oldest first) and starts
        its prefill cursor past the hits. With a host tier, the chain's
        hosted continuation is promoted first (`_prefetch_for_admission`)
        and the head waits while copies are in flight. A preempted request
        re-admits through `_admit_resume`. Admission gates on
        `available_after_adopt`. Returns True when page tables changed."""
        ps = self.page_size
        changed = False
        for i in range(self.batch):
            if self.rows[i] is not None or not self.queue:
                continue
            k = self._next_candidate_index()
            cand = self.queue[k]
            if cand.uid in self._suspended:
                if not self._admit_resume(i, k, cand):
                    break                        # wait for releases
                changed = True
                continue
            S = len(cand.prompt)
            nb = S // ps                         # hashable full pages
            init = self._initial_pages(S, cand.max_new_tokens)
            if cand.uid in self._admit_memo:     # a blocked head's retry
                toks, chain = self._admit_memo[cand.uid]
            else:
                toks = np.asarray(cand.prompt, np.int32)
                chain = (chain_hashes(toks[:nb * ps], ps)
                         if self.prefix_cache else [])
                self._admit_memo[cand.uid] = (toks, chain)
            # start the promotions of the chain's hosted continuation; the
            # head swap-waits while they are in flight
            if self._tiering is not None and \
                    self._prefetch_for_admission(cand.uid, chain, S):
                break
            hit_toks = (self._cap_hits(self.allocator.match(chain), S)
                        if self.prefix_cache else 0)
            hit = hit_toks // ps                 # adopted pages
            if init - hit > self.allocator.available_after_adopt(chain[:hit]):
                break                            # wait for releases
            del self.queue[k]
            self._admit_memo.pop(cand.uid, None)
            ids = (self.allocator.adopt(chain[:hit]) if hit else []) \
                + self.allocator.alloc(init - hit)
            if self.prefix_cache:
                self.allocator.misses += nb - hit
            self.rows[i] = cand
            self.row_pages[i] = ids
            self.tables[i, :] = 0
            self.tables[i, :init] = ids
            self.streams[i] = toks
            self.row_chain[i] = chain
            self.gen_base[i] = 0
            self.prefilling[i] = {"toks": toks, "cursor": hit_toks, "S": S}
            self.pos[i] = hit_toks
            self.tok[i, 0] = 0
            changed = True
        if changed:
            self._progressed = True
        return changed

    def _admit_resume(self, i: int, k: int, cand: Request) -> bool:
        """Re-admit the preempted request ``cand`` (queue index ``k``) into
        row ``i``. Fast resume: every full page of the suspended stream
        (prompt + generated) is still indexed and the residual snapshot
        exists, so the row adopts those pages, gets its residual and
        pending token back and rejoins decode without prefill; its tokens
        are a never-preempted run's (the same pages, the same residual,
        draws indexed by token). Swap restore: with a host tier, pages
        reclaimed since the preemption but held on the tier are promoted
        (the request swap-waits while copies are in flight) and the fast
        path then adopts them, bit for bit the same (verbatim bytes; a
        ``host_tier_dtype`` is the lossy exception). Recompute resume:
        some page is gone, so the stream is prefilled again over whatever
        hits remain, and the pending token is restored at the prefill
        boundary, not drawn again (the recomputed cache may differ at
        quantization noise). Returns False when the pool cannot host the
        resume yet."""
        ps = self.page_size
        snap = self._suspended[cand.uid]
        full, fchain = snap["full_toks"], snap["full_chain"]
        Sf, nbf = len(full), len(full) // ps
        rem = cand.max_new_tokens - len(cand.generated)
        init = self._initial_pages(Sf, rem)
        resident = self.allocator.match(fchain) if self.prefix_cache else 0
        if (self._tiering is not None and resident < nbf
                and snap["resid"] is not None):
            dev, swap = self.allocator.match_tiered(fchain)
            if dev + swap >= nbf and swap > 0 \
                    and self._swap_cost.prefer_swap(nbf - dev):
                snap["swapped"] = True
                if self._prefetch_for_admission(cand.uid, fchain, Sf,
                                                want_pages=nbf):
                    return False                 # swap-wait
                resident = self.allocator.match(fchain)
        fast = resident >= nbf and snap["resid"] is not None
        hit_toks = 0 if fast or not self.prefix_cache else \
            self._cap_hits(resident, Sf)
        hit = nbf if fast else hit_toks // ps
        if init - hit > self.allocator.available_after_adopt(fchain[:hit]):
            return False
        ids = (self.allocator.adopt(fchain[:hit]) if hit else []) \
            + self.allocator.alloc(init - hit)
        if self.prefix_cache and not fast:
            self.allocator.misses += nbf - hit
        del self.queue[k]
        del self._suspended[cand.uid]
        self._swap_wait.pop(cand.uid, None)
        self.rows[i] = cand
        self.row_pages[i] = ids
        self.tables[i, :] = 0
        self.tables[i, :init] = ids
        self.streams[i] = full
        self.row_chain[i] = fchain
        self.gen_base[i] = len(cand.generated)
        if fast:
            self.pos[i] = Sf
            self.tok[i, 0] = snap["pending"]
            self._restore_resid(i, snap["resid"])
            self.preempt_fast_resumes += 1
            if snap.get("swapped"):
                self.preempt_swap_restores += 1
        else:
            self.prefilling[i] = {"toks": full, "cursor": hit_toks, "S": Sf}
            self.pos[i] = hit_toks
            self.tok[i, 0] = 0
            self._resume_tok[i] = snap["pending"]
            self.preempt_recompute_resumes += 1
        return True

    def _chunk_prefill_fn(self, max_start: int):
        """Chunk step for a dispatch whose deepest cursor is ``max_start``
        tokens: the history walk is bounded by the cursor in pages rounded
        up to a power of two (the reference's compile set). Keyed
        ``(hist_blocks, use_fused_prefill, kv_cache_dtype)`` as the
        reference's, the flag and the dtype read from the live config at
        every dispatch: flipping either gives a new step, never a stale
        one (``use_fused_prefill=False``: the dequantize-gather oracle,
        `attention.prefill_chunk`)."""
        blocks = -(-max_start // self.page_size)
        hb = 0 if blocks == 0 else min(1 << (blocks - 1).bit_length(),
                                       self.max_blocks)
        fused = self.config.use_fused_prefill
        key = (hb, fused, self.kv_cache_dtype)
        fn = self._chunk_prefill_fns.get(key)
        if fn is None:
            fn = self._chunk_prefill_fns[key] = self._dispatch.step(
                make_chunk_prefill_fn(self.cfg, hist_blocks=hb,
                                      use_fused=fused),
                name=f"chunk_prefill[{hb}{'' if fused else ', oracle'}]",
                opaque=(0, 2), state_arg=2)
        return fn

    def _chunk_width(self, rem: int) -> int:
        """Dispatch width for a row with ``rem`` prompt tokens left: the
        chunk size, or for a final partial chunk a power-of-two page count
        (capped at the chunk size)."""
        cp = self.prefill_chunk_tokens
        if rem >= cp:
            return cp
        pages = -(-rem // self.page_size)
        return min(self.page_size * (1 << (pages - 1).bit_length()), cp)

    def _advance_prefill(self) -> list[Request]:
        """Advance one prompt chunk for the mid-prefill rows whose next
        chunk has the round-robin head's dispatch width; with the prefix
        cache, each chunk's completed pages are published at once (a
        concurrent identical prompt can adopt them); rows finishing their
        prompt draw their first token. Returns requests whose first draw
        was a stop token (finished with empty output)."""
        if not self.prefilling:
            return []
        ps = self.page_size
        order = sorted(self.prefilling)
        head = order[self._pf_rr % len(order)]
        self._pf_rr += 1
        rem_of = {i: st["S"] - st["cursor"]
                  for i, st in self.prefilling.items()}
        w = self._chunk_width(rem_of[head])
        group = [i for i in order if self._chunk_width(rem_of[i]) == w]
        toks = np.zeros((self.batch, w), np.int32)
        start = np.zeros((self.batch,), np.int32)
        valid = np.zeros((self.batch,), np.int32)
        mask = np.zeros((self.batch,), bool)
        for i in group:
            st = self.prefilling[i]
            c = min(self.prefill_chunk_tokens, rem_of[i])
            toks[i, :c] = st["toks"][st["cursor"]:st["cursor"] + c]
            start[i] = st["cursor"]
            valid[i] = c
            mask[i] = True
        b = self._inputs
        logits, self.state = self._chunk_prefill_fn(int(start.max()))(
            self.params, self._upload(b.chunk_tokens(w), toks), self.state,
            self._upload(b.start, start), self._upload(b.valid, valid),
            self._upload(b.pf_mask, mask))
        self._progressed = True
        self.prefill_tokens_computed += int(valid.sum())
        sampled = None
        # a recompute resume restores its pending token: it draws nothing
        finishing = [i for i in group
                     if rem_of[i] <= self.prefill_chunk_tokens
                     and i not in self._resume_tok]
        done: list[Request] = []
        for i in group:
            st = self.prefilling[i]
            c = int(valid[i])
            if self.prefix_cache:
                # pages fully inside [cursor, cursor + c) are final
                for b in range(st["cursor"] // ps, (st["cursor"] + c) // ps):
                    self.allocator.register(int(self.tables[i, b]),
                                            self.row_chain[i][b])
            st["cursor"] += c
            self.pos[i] = st["cursor"]
            if st["cursor"] == st["S"]:
                rtok = self._resume_tok.pop(i, None)
                if rtok is not None:
                    # a recompute resume is complete: its pending token was
                    # drawn (and its first token timed) before preemption
                    del self.prefilling[i]
                    self.tok[i, 0] = rtok
                    continue
                if sampled is None:      # token index 0 for finishing rows
                    sampled = self._sample_rows(logits, finishing, offset=0)
                del self.prefilling[i]
                r = self.rows[i]
                if int(sampled[i]) in self._stop_ids(r):
                    self._finish(r, "stop_token")
                    done.append(r)
                    self._release_row(i)
                    continue
                self.tok[i, 0] = sampled[i]
                self._record_first_token(r)
        return done

    # -- the host tier ------------------------------------------------------
    # Pools are written in place, so the copies are ordered by streams: a
    # demotion is enqueued on the current stream, before the write that
    # reuses its page; a promotion runs on a side stream after everything
    # already enqueued, and the current stream waits on its event when the
    # page is published, before any kernel reads it. Host tensors are
    # pinned and every copy is non-blocking: no host sync.
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _index_tensor(self, pages) -> torch.Tensor:
        """Page ids as an int64 tensor on the batcher's device (through
        pinned memory on the card: no host sync)."""
        t = torch.tensor(pages, dtype=torch.int64)
        if self._on_card():
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _queue_demotion(self, page: int, digest: bytes) -> bool:
        """The allocator's ``demote_hook``: queue indexed ``page`` for a
        copy to the host tier under ``digest`` (`_flush_demotions` copies
        the queue). Skips a digest already held (the first copy is the
        copy), no pools yet, or a copy the cost model prices above a
        recompute. Returns True iff queued."""
        tier = self._tiering
        if tier is None or self.state is None or digest in tier \
                or any(h == digest for _, h in self._demote_queue):
            return False
        if not self._swap_cost.prefer_swap(1):
            return False
        self._demote_queue.append((page, digest))
        return True

    def _layer_groups(self, dtypes) -> dict:
        """Layer indices grouped by ``dtypes[l]`` (a key per layer), in
        layer order: the layers one batched repack or gather serves."""
        groups: dict = {}
        for l, key in enumerate(dtypes):
            groups.setdefault(key, []).append(l)
        return groups

    def _host_views(self, hq, hs) -> list:
        """A slot's per-layer ``(k_q, k_s, v_q, v_s)`` views (values as
        bytes in the layer's host dtype, float32 scales)."""
        m = self.cfg
        out = []
        for l, (off, n, _) in enumerate(self._host_layout):
            q = hq[off:off + n].view(2, -1, m.n_kv_heads, m.head_dim)
            out.append((q[0], hs[l, 0], q[1], hs[l, 1]))
        return out

    def _flush_demotions(self) -> None:
        """Copy the queued pages to the host tier: per group of layers
        sharing a dtype one index_select of the pages from each pool
        tensor, repacked on the device to ``host_tier_dtype`` when set
        (a layer already in it is copied as it is), laid out as the slab's
        slot (`_new_allocator`), then per page one non-blocking copy of
        its values and one of its scales into a slot of the host slab,
        enqueued before any later write to those pages. Each page becomes
        one record (in queue order; a full tier drops its coldest record
        first), its bytes views of the slot, readable on the host after
        its ``ready`` event."""
        queue, self._demote_queue = self._demote_queue, []
        if not queue:
            return
        tier, slab, card = self._tiering, self._host_slab, self._on_card()
        ids = self._index_tensor([p for p, _ in queue])
        n, L = len(queue), len(self.state)
        qs, ss = [None] * L, [None] * L
        for src, ls in self._layer_groups(self._layer_dtypes()).items():
            cs = [self.state[l] for l in ls]
            q = torch.stack([torch.stack(
                [_as_bytes(c.pool.k_q).index_select(0, ids),
                 _as_bytes(c.pool.v_q).index_select(0, ids)], 1)
                for c in cs], 1)                  # (n, layers, 2, tp, H, D)
            s = torch.stack([torch.stack([c.pool.k_s.index_select(0, ids),
                                          c.pool.v_s.index_select(0, ids)], 1)
                             for c in cs], 1)
            dst = tier.dtype or src
            if dst != src:
                q, s = TIER.repack_page(q.view(Q.kv_storage_dtype(src)), s,
                                        src, dst)
                q = _as_bytes(q)
            for j, l in enumerate(ls):
                qs[l], ss[l] = q[:, j].reshape(n, -1), s[:, j]
        q, s = torch.cat(qs, 1), torch.stack(ss, 1)
        dtypes = [hd for _, _, hd in self._host_layout]
        recs = []
        for j, (_, digest) in enumerate(queue):
            if len(tier) >= tier.capacity:
                tier.evict_oldest()
            slot = slab.take()
            hq, hs = slab.q[slot], slab.s[slot]
            hq.copy_(q[j], non_blocking=card)
            hs.copy_(s[j], non_blocking=card)
            tier.put(digest, self._host_views(hq, hs), dtypes,
                     blocks=(hq, hs), slot=slot)
            recs.append(tier.pages[digest])
        if card:
            ready = torch.cuda.Event()
            ready.record()
            for r in recs:
                r.ready = ready

    def _demote_to_host(self, page: int, digest: bytes) -> bool:
        """Copy one indexed device page to the host tier under ``digest``
        now (`_queue_demotion`, then `_flush_demotions`). Returns True iff
        a new record was stored."""
        queued = self._queue_demotion(page, digest)
        self._flush_demotions()
        return queued

    def _demote_chain(self, chain) -> int:
        """Copy every device-resident page of ``chain`` to the host tier
        in one batch (preempt-by-swap). Returns the pages copied."""
        n = sum(self._queue_demotion(self.allocator.index[h], h)
                for h in chain if h in self.allocator.index)
        self._flush_demotions()
        return n

    def _write_host_pages(self, pages: list[int], recs) -> None:
        """Promotion: copy host records into device ``pages``. On the card
        on a side stream that first waits for everything already enqueued
        (a demotion of the page's old content among it) and for each
        record's own copy out: one non-blocking copy per record in, the
        repack to each layer's pool dtype on the device where the record's
        differs (one per group of layers alike), then one scatter per pool
        tensor per layer; its event is waited on by the current stream
        when the page is published (`_sync_promotions`)."""
        last = {p: r for p, r in zip(pages, recs)}   # a page reused: last
        pages, recs = list(last), list(last.values())
        card = self._on_card()
        ids = self._index_tensor(pages)
        side = None
        if card:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            side = self._copy_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            for r in recs:
                if r.ready is not None:
                    side.wait_event(r.ready)
        with torch.cuda.stream(side) if card else contextlib.nullcontext():
            q0, s0 = recs[0].blocks
            q = torch.empty((len(recs),) + tuple(q0.shape), dtype=q0.dtype,
                            device=self.device)
            s = torch.empty((len(recs),) + tuple(s0.shape), dtype=s0.dtype,
                            device=self.device)
            for j, r in enumerate(recs):
                q[j].copy_(r.blocks[0], non_blocking=card)
                s[j].copy_(r.blocks[1], non_blocking=card)
            m, n = self.cfg, len(recs)
            views = [q[:, off:off + size].view(n, 2, -1, m.n_kv_heads,
                                                m.head_dim)
                     for off, size, _ in self._host_layout]
            pairs = list(zip(recs[0].dtypes, self._layer_dtypes()))
            for (src, dst), ls in self._layer_groups(pairs).items():
                gq, gs = [views[l] for l in ls], [s[:, l] for l in ls]
                if src != dst:
                    rq, rs = TIER.repack_page(
                        torch.stack(gq, 1).view(Q.kv_storage_dtype(src)),
                        torch.stack(gs, 1), src, dst)
                    gq, gs = rq.unbind(1), rs.unbind(1)
                for l, lq, ls_ in zip(ls, gq, gs):
                    self.state[l].pool.write(ids, lq[:, 0], ls_[:, 0],
                                             lq[:, 1], ls_[:, 1])
        if not card:
            return
        ids.record_stream(side)
        for c in self.state:
            for t in (c.pool.k_q, c.pool.v_q, c.pool.k_s, c.pool.v_s):
                t.record_stream(side)
        done = torch.cuda.Event()
        done.record(side)
        for r in recs:
            r.read = done
        for p in pages:
            self._promo_events[p] = (done, recs)
        self._sync_promotions()

    def _sync_promotions(self) -> None:
        """The current stream waits on the copy of every promoted page
        that has left the in-flight population (published, or aborted and
        free again), before any kernel can read or rewrite it."""
        a = self.allocator
        for p in [p for p in self._promo_events if p not in a.inflight]:
            torch.cuda.current_stream(self.device).wait_event(
                self._promo_events.pop(p)[0])

    def _issue_prefetch(self, chain, lo: int, n: int) -> int:
        """Start promotions of the hosted digests ``chain[lo:lo+n]``: a
        staging page each (`HostPageAllocator.begin_prefetch`, published
        at once or after the injector's ``swap_delay`` ticks), then the
        copies (`_write_host_pages`). An injected swap fault loses the
        record instead (the run ends there, the requester recomputes).
        Returns the copies started."""
        a, tier, slab = self.allocator, self._tiering, self._host_slab
        inj = a.injector
        pages, recs = [], []
        for h in chain[lo:lo + n]:
            if h in a.index or h in a.inflight_digests:
                continue                 # already resident or staging
            if h not in tier.pages or a.available < 1:
                break
            if inj is not None and inj.swap_fault():
                tier.drop(h)
                break
            delay = inj.swap_delay if inj is not None else 0
            rec = tier.pages[h]
            slab.hold(rec)               # its bytes stay until copied in
            pages.append(a.begin_prefetch(h, delay))
            if h in tier.pages:
                recs.append(tier.get(h))
            else:
                # the staging page's own reclaim demoted a page that pushed
                # this record off a full tier: its held bytes still promote
                # (the reference raises KeyError here)
                rec.hits += 1
                tier.promotions += 1
                recs.append(rec)
        if pages:
            self._write_host_pages(pages, recs)
        for rec in recs:
            slab.unhold(rec)
        return len(pages)

    def _prefetch_for_admission(self, uid: int, chain, prompt_len: int,
                                want_pages: int | None = None) -> bool:
        """Promote the hosted continuation of ``chain`` for a candidate
        before it is admitted. ``want_pages`` caps the useful depth (the
        `_cap_hits` grid for a fresh prompt; the whole stream for a
        resume). Returns True while copies it needs are in flight: the
        candidate swap-waits (``_swap_wait``, shown by the stuck report)
        instead of recomputing pages a copy restores for less."""
        a = self.allocator
        dev, swap = a.match_tiered(chain)
        if want_pages is None:
            want_pages = self._cap_hits(dev + swap, prompt_len) \
                // self.page_size
        want_pages = min(want_pages, dev + swap)
        if want_pages <= dev or \
                not self._swap_cost.prefer_swap(want_pages - dev):
            self._swap_wait.pop(uid, None)
            return False
        self._issue_prefetch(chain, dev, want_pages - dev)
        in_flight = sum(1 for h in chain[dev:want_pages]
                        if h in a.inflight_digests)
        if in_flight:
            self._swap_wait[uid] = in_flight
            return True
        self._swap_wait.pop(uid, None)
        return False

    # -- preemption --------------------------------------------------------
    def _snapshot_resid(self, i: int) -> list:
        """Row ``i``'s fp residual (its partial page) in every layer, as
        copies on the batcher's device: with the pending token, all of the
        row's state that is not in immutable pages. No host sync."""
        return [(c.resid_k[i].clone(), c.resid_v[i].clone())
                for c in self.state]

    def _restore_resid(self, i: int, snaps: list) -> None:
        """Write a `_snapshot_resid` snapshot back into row ``i`` of each
        layer's residual, in place."""
        for c, (k, v) in zip(self.state, snaps):
            c.resid_k[i].copy_(k)
            c.resid_v[i].copy_(v)

    def _pick_victim(self) -> int | None:
        """The running row to preempt: lowest priority, then latest
        arrival. Never the last running row: it can always grow to its
        budget (its worst case fits the pool, checked at submit), which
        guarantees progress."""
        running = [i for i, r in enumerate(self.rows) if r is not None]
        if len(running) <= 1:
            return None
        return min(running,
                   key=lambda i: (self.rows[i].priority
                                  if self.rows[i].priority is not None else 0,
                                  -getattr(self.rows[i], "_arrival", i)))

    def _preempt_row(self, i: int) -> None:
        """Suspend row ``i`` and re-queue its request. A decoding row keeps
        a snapshot (pending token, residuals, full token stream and its
        hash chain) for `_admit_resume`; its release publishes its pages
        (`_promote_on_release`), so they park on the LRU still indexed and
        a fast resume adopts them back. With a host tier those pages are
        also copied to it at once (preempt-by-swap), so a resume after the
        device copies were reclaimed restores instead of recomputing. A
        row mid-prefill re-queues plainly unless it is a recompute resume,
        which keeps its pending token. Past ``preempt_loop_limit``
        preemptions without progress, raises `PoolExhaustedError`."""
        r = self.rows[i]
        swap_chain = None
        self._preempts_since_progress += 1
        if self._preempts_since_progress > self.preempt_loop_limit:
            holders = {rr.uid: len(self.row_pages[j])
                       for j, rr in enumerate(self.rows) if rr is not None}
            raise PoolExhaustedError(
                f"pool exhausted: {self._preempts_since_progress} "
                f"preemption(s) without any request advancing (limit "
                f"{self.preempt_loop_limit}); page holders "
                f"(uid -> pages): {holders}; "
                f"available={self.allocator.available} of "
                f"{self.n_pages - 1}; {self._stuck_report()}")
        self.preemptions += 1
        ps = self.page_size
        if i in self.prefilling:
            rtok = self._resume_tok.pop(i, None)
            if rtok is not None:
                self._suspended[r.uid] = {
                    "pending": rtok, "resid": None,
                    "full_toks": self.streams[i],
                    "full_chain": list(self.row_chain[i])}
        else:
            full = np.concatenate(
                [self.streams[i],
                 np.asarray(r.generated[self.gen_base[i]:], np.int32)])
            fchain = (chain_hashes(full[:(len(full) // ps) * ps], ps)
                      if self.prefix_cache else [])
            self._suspended[r.uid] = {
                "pending": int(self.tok[i, 0]),
                "resid": self._snapshot_resid(i),
                "full_toks": full,
                "full_chain": fchain}
            swap_chain = fchain
        self._release_row(i)
        if (swap_chain and self._tiering is not None
                and self._swap_cost.prefer_swap(len(swap_chain))):
            if self._demote_chain(swap_chain):
                self.preempt_by_swap += 1
        r._submit_tick = self.ticks         # its aging clock restarts
        self.queue.append(r)

    def _ensure_decode_pages(self, active: list[int]
                             ) -> tuple[list[int], int, bool]:
        """The growth pass before a decode chunk under a watermark: every
        page the n-step chunk can flush into must be mapped first (an
        unmapped block would flush into the sentinel). Grows each active
        row's reservation to cover pos + n; when the pool cannot, preempts
        victims (`_pick_victim`) until it can, and when none is left stalls
        the lowest-priority needy rows for this tick (they keep their pages
        and retry). Host only. Returns (rows to decode, n, tables
        changed)."""
        ps = self.page_size
        changed = False
        for _ in range(4 * self.batch + 8):      # a bound, never reached
            if not active:
                return active, 0, changed
            n = self._chunk_len(active)
            need = {}
            for i in active:
                want = -(-(int(self.pos[i]) + n) // ps)
                have = len(self.row_pages[i])
                if want > have:
                    need[i] = want - have
            if not need:
                return active, n, changed
            if sum(need.values()) <= self.allocator.available:
                # highest priority grows first
                for i in sorted(need,
                                key=lambda j: (-(self.rows[j].priority or 0),
                                               getattr(self.rows[j],
                                                       "_arrival", j))):
                    ids = self.allocator.alloc(need[i])
                    have = len(self.row_pages[i])
                    self.tables[i, have:have + len(ids)] = ids
                    self.row_pages[i].extend(ids)
                return active, n, True
            victim = self._pick_victim()
            if victim is None:
                # stall the lowest-priority needy rows until the rest fit;
                # loop again, as n can change with the set
                order = sorted(need,
                               key=lambda j: ((self.rows[j].priority or 0),
                                              -getattr(self.rows[j],
                                                       "_arrival", j)))
                while order and sum(need[j] for j in order) \
                        > self.allocator.available:
                    drop = order.pop(0)
                    self.decode_stall_ticks += 1
                    active = [i for i in active if i != drop]
                continue
            self._preempt_row(victim)
            changed = True
            active = [i for i in active if self.rows[i] is not None]
        return [], 0, changed                    # the bound: stall the tick

    def _cow_retarget(self, active: list[int], n: int) -> bool:
        """Copy-on-write before an n-step decode scan: every page the scan
        will flush into must be private (a shared or indexed page is
        immutable). Returns True if tables changed."""
        ps = self.page_size
        changed = False
        for i in active:
            pos = int(self.pos[i])
            for b in range(pos // ps, (pos + n) // ps):
                page = int(self.tables[i, b])
                if page == SENTINEL_PAGE:
                    continue
                new = self.allocator.ensure_private(page)
                if new is not None:
                    self.row_pages[i][self.row_pages[i].index(page)] = new
                    self.tables[i, b] = new
                    changed = True
        return changed

    def _step_paged(self) -> list[Request]:
        """One paged tick: the allocator's tick (injector draw, deferred
        pages), admission, one prefill chunk, under a watermark the growth
        pass, then one decode chunk for the rows past prefill. Without a
        watermark the worst-case reservation makes growth impossible and
        the pass does not run."""
        if self.state is None:
            self.state = self._new_state()
        self.allocator.tick()
        if self._promo_events:
            self._sync_promotions()
        if self._admit_chunked():
            self._sync_device()
        done = self._advance_prefill()
        active = [i for i, r in enumerate(self.rows)
                  if r is not None and i not in self.prefilling]
        n = None
        if active and self.watermark is not None:
            active, n, grew = self._ensure_decode_pages(active)
            if grew:
                self._sync_device()
        if active:
            row_mask = np.zeros((self.batch,), bool)
            row_mask[active] = True
            done = done + self._decode_tick(active, row_mask, n=n)
        if done:
            self._sync_device()
        return done

    # -- introspection -----------------------------------------------------
    def pool_report(self) -> dict:
        """Ticks, token counters and TTFT percentiles; paged, also the page
        populations: ``pages_allocated`` referenced, ``pages_cached`` on the
        LRU (refcount 0, still hittable), ``pages_inflight`` staging a
        promotion, ``pages_live`` the distinct pages holding tokens and
        ``device_bytes_live`` their bytes over every layer; the dtype's
        ``pages_vs_int8_equal_hbm`` and ``kv_page_bytes_saved_vs_int8_frac``;
        the overload counters (preemptions, fast and recompute resumes,
        stalled row-ticks); with the prefix cache, the allocator's hit,
        miss, reclaim and copy-on-write counters; with a host tier, its
        occupancy and bytes (against its own capacity), its traffic and
        the cost model's prices; with a fault injector, its counters and
        the deferred pages."""
        if not self.paged:
            return {"ticks": self.ticks,
                    "decode_tokens_computed": self.decode_tokens_computed,
                    **self.lifecycle_report()}
        lengths = [int(self.pos[i]) if r is not None else 0
                   for i, r in enumerate(self.rows)]
        a = self.allocator
        allocated = (self.n_pages - 1) - a.n_free - a.n_cached \
            - len(a.deferred) - len(a.inflight)
        live = live_page_count(self.tables, lengths, self.page_size)
        pb = lambda dt: page_bytes_for(self.page_size, self.cfg.n_kv_heads,
                                       self.cfg.head_dim, dt)
        layer_dts = self._layer_dtypes()
        stack_bytes = sum(pb(dt) for dt in layer_dts)
        int8_bytes = pb("int8") * len(layer_dts)
        spec = self.kv_cache_dtype
        rep = {"kv_cache_dtype": spec if isinstance(spec, str) else "mixed",
               "pages_vs_int8_equal_hbm": int8_bytes / stack_bytes,
               "kv_page_bytes_saved_vs_int8_frac":
                   1.0 - stack_bytes / int8_bytes,
               "pages_total": self.n_pages - 1,
               "pages_free": a.n_free,
               "pages_cached": a.n_cached,
               "pages_allocated": allocated,
               "pages_inflight": len(a.inflight),
               "pages_live": live,
               "utilization": live / max(allocated, 1),
               "device_bytes_live": live * stack_bytes,
               "preemptions": self.preemptions,
               "preempt_fast_resumes": self.preempt_fast_resumes,
               "preempt_recompute_resumes": self.preempt_recompute_resumes,
               "decode_stall_ticks": self.decode_stall_ticks,
               "ticks": self.ticks,
               "prefill_tokens_computed": self.prefill_tokens_computed,
               "decode_tokens_computed": self.decode_tokens_computed,
               **self.lifecycle_report()}
        if not isinstance(spec, str):
            rep["kv_cache_layer_dtypes"] = list(layer_dts)
        if self.prefix_cache:
            rep.update({"page_hits": a.hits, "page_misses": a.misses,
                        "page_hit_rate": a.hits / max(a.hits + a.misses, 1),
                        "reclaims": a.reclaims,
                        "cow_retargets": a.cow_retargets})
        if self._tiering is not None:
            t, cm = self._tiering, self._swap_cost
            rep.update({
                "host_pages_capacity": t.capacity,
                "host_pages_used": len(t),
                "host_utilization": len(t) / max(t.capacity, 1),
                "host_bytes": t.nbytes,
                "host_tier_dtype": t.dtype,
                "evictor": self.config.evictor,
                "demotions": t.demotions,
                "promotions": t.promotions,
                "host_evictions": t.host_evictions,
                "host_lost_records": t.lost,
                "prefetch_issued": a.prefetch_issued,
                "prefetch_page_hits": a.promote_hits,
                "prefetch_hit_rate":
                    a.promote_hits / max(a.prefetch_issued, 1),
                "preempt_by_swap": self.preempt_by_swap,
                "preempt_swap_restores": self.preempt_swap_restores,
                "swap_cost_tokens_per_page": cm.swap_cost(1),
                "recompute_cost_tokens_per_page": cm.recompute_cost(1),
                "est_prefill_tokens_saved_by_swap":
                    a.promote_hits * (cm.recompute_cost(1)
                                      - cm.swap_cost(1))})
        if a.injector is not None:
            rep.update({
                "injected_alloc_fault_ticks": a.injector.alloc_fault_ticks,
                "injected_delayed_releases": a.injector.delayed_releases,
                "injected_held_pages": a.injector.hold_pages,
                "injected_swap_faults": a.injector.swap_faults,
                "pages_deferred": len(a.deferred)})
        return rep
