"""Host-side continuous-batching scheduler over the quantized cache (port
of ``repro.serving.scheduler``, both backends).

A fixed pool of ``batch`` rows; empty rows refill from a FCFS request
queue between device steps.

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
tick with decode so a long prompt never stalls running rows. Decode ticks
scan up to ``chunk`` tokens per dispatch, never past the smallest
remaining budget, rounded down to a power of two. Stop tokens, the engine
``eos_id`` and stop strings finish a row; tokens past a mid-chunk stop are
discarded (decode is causal).

Not ported yet (they raise in `EngineConfig`): prefix caching, overload
(watermark admission, preemption, priorities, the stall watchdog), the
host swap tier, mixed precision plans and sampled requests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.paging import HostPageAllocator, live_page_count
from repro_torch.models import sampling as SMP
from repro_torch.models import transformer as T
from repro_torch.serving.engine import make_chunk_prefill_fn, make_serve_fns
from repro_torch.serving.params import (EngineConfig, SamplingParams,
                                        default_detokenize)


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
    seconds."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int | None = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams.greedy)
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
        self.device = T.check_device(device)
        T.check_servable(cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"batcher on {self.device}")
        self.paged = config.paged
        if self.paged and cfg.quant.granularity != "per_block":
            raise ValueError("paged serving requires per_block quantization")
        if config.prefill_chunk is not None and not self.paged:
            raise ValueError("chunked prefill requires the paged backend "
                             "(paged=True)")
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
        if self.paged:
            self.page_size = cfg.quant.block_size
            self.max_blocks = self.max_len // self.page_size
            self.n_pages = (config.n_pages if config.n_pages is not None
                            else self.batch * self.max_blocks + 1)
            self.allocator = HostPageAllocator(self.n_pages)
            self.tables = np.zeros((self.batch, self.max_blocks), np.int32)
            self.row_pages: list[list[int]] = [[] for _ in range(self.batch)]
            pc = config.prefill_chunk or 4 * self.page_size
            self.prefill_chunk_tokens = -(-pc // self.page_size) * \
                self.page_size
            self._chunk_prefill_fns: dict[int, object] = {}
            self.prefilling: dict[int, dict] = {}   # row -> toks/cursor/S
            self._pf_rr = 0
        self.kv_cache_dtype = config.kv_cache_dtype
        self._init_state, self._prefill, self._decode = make_serve_fns(
            cfg, max_len=self.max_len, paged=self.paged, n_pages=self.n_pages,
            kv_cache_dtype=self.kv_cache_dtype, device=self.device)
        self.queue: deque[Request] = deque()
        self.rows: list[Request | None] = [None] * self.batch
        self.pos = np.zeros((self.batch,), np.int32)
        self.tok = np.zeros((self.batch, 1), np.int32)
        self.state = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def submit(self, req: Request):
        """Queue a request. Every check runs before any state changes, so a
        rejected request leaves the batcher as it was."""
        if req.uid in self._inflight_uids:
            raise ValueError(f"request uid {req.uid} is already in flight "
                             f"(queued or running)")
        want = req.sampling.kv_cache_dtype
        if want is not None and want != self.kv_cache_dtype:
            raise ValueError(f"request {req.uid}: kv_cache_dtype={want!r} "
                             f"does not match the engine's pool backend "
                             f"({self.kv_cache_dtype!r})")
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
        req.submit_time = time.perf_counter()
        self._inflight_uids.add(req.uid)
        self.queue.append(req)

    def _pad(self, n: int) -> int:
        """``n`` tokens rounded up to the block (the contiguous prefill
        length; at least one block)."""
        return -(-max(n, 1) // self.block) * self.block

    # -- lifecycle helpers -------------------------------------------------
    def _sample_rows(self, logits) -> np.ndarray:
        temps = [r.sampling.temperature if r is not None else 0.0
                 for r in self.rows]
        return SMP.sample_at_step(logits, temps,
                                  vocab=self.cfg.vocab).cpu().numpy()

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
        Returns requests finished now."""
        self.ticks += 1
        return self._step_paged() if self.paged else self._step_contiguous()

    def run_to_completion(self, max_ticks: int = 10_000) -> list[Request]:
        out = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.rows):
                return out
        stranded = sorted([r.uid for r in self.queue] +
                          [r.uid for r in self.rows if r is not None])
        raise RuntimeError(f"run_to_completion: max_ticks={max_ticks} "
                           f"exhausted with requests {stranded} in flight")

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
                     row_mask: np.ndarray | None = None) -> list[Request]:
        """Decode one chunk for the active rows (all rows advance in the
        contiguous cache; paged rows outside ``row_mask`` stay frozen)."""
        n = self._chunk_len(active)
        self.decode_tokens_computed += n * len(active)
        tok, pos = self._dev(self.tok), self._dev(self.pos)
        mask = None if row_mask is None else self._dev(row_mask)
        if n == 1:
            logits, self.state = self._decode(self.params, tok, self.state,
                                              pos, mask)
            return self._finish_tick(active, self._sample_rows(logits))
        pending, self.state, toks = T.decode_scan(
            self.params, tok, self.cfg, self.state, pos, steps=n,
            row_mask=mask)
        return self._finish_chunk(active, toks.cpu().numpy(),
                                  pending.cpu().numpy())

    def _release_row(self, i: int):
        """Free row ``i``; paged, its pages return to the free list. The
        device table and length stay stale until the next `_sync_device`
        (before any page is handed out again); the dead row's output is
        discarded."""
        self.rows[i] = None
        self.pos[i] = 0
        self.tok[i, 0] = 0
        if self.paged:
            self.allocator.release(self.row_pages[i])
            self.row_pages[i] = []
            self.tables[i, :] = 0
            self.prefilling.pop(i, None)

    def _sync_device(self):
        """Push the host page tables and per-row lengths (active rows:
        ``pos``; free rows: 0) into every layer's cache."""
        lengths = np.where(np.asarray([r is not None for r in self.rows]),
                           self.pos, 0).astype(np.int32)
        table, length = self._dev(self.tables), self._dev(lengths)
        for c in self.state:
            c.page_table, c.length = table, length

    # -- contiguous backend --------------------------------------------------
    def _admit_rows(self) -> list[int]:
        """Fill empty rows FCFS, deferring a candidate whose admission would
        overflow the cache after the rebuild: the rebuild restarts every
        active row at the group's padded history length S, so each row's S
        plus remaining budget must fit max_len."""
        active = [r for r in self.rows if r is not None]
        new: list[int] = []
        free = [i for i in range(self.batch) if self.rows[i] is None]
        while free[len(new):] and self.queue:
            cand = self.queue[0]
            group = active + [self.rows[i] for i in new] + [cand]
            S = self._pad(max(len(r.prompt) + len(r.generated)
                              for r in group))
            if any(S + r.max_new_tokens - len(r.generated) > self.max_len
                   for r in group):
                break                          # wait until rows free up
            i = free[len(new)]
            self.queue.popleft()
            self.rows[i] = cand
            new.append(i)
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
            logits, self.state = self._prefill(self.params, self._dev(toks),
                                               self.state)
            nxt = self._sample_rows(logits)
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
    def _admit_chunked(self) -> bool:
        """Admit queued requests FCFS into free rows; each takes its full
        reservation (`pages_for_request`) and starts its prefill cursor at
        0. Returns True when page tables changed."""
        changed = False
        for i in range(self.batch):
            if self.rows[i] is not None or not self.queue:
                continue
            cand = self.queue[0]
            S = len(cand.prompt)
            init = pages_for_request(S, cand.max_new_tokens, self.page_size)
            if init > self.allocator.n_free:
                break                            # wait for releases
            self.queue.popleft()
            ids = self.allocator.alloc(init)
            self.rows[i] = cand
            self.row_pages[i] = ids
            self.tables[i, :] = 0
            self.tables[i, :init] = ids
            self.prefilling[i] = {"toks": np.asarray(cand.prompt, np.int32),
                                  "cursor": 0, "S": S}
            self.pos[i] = 0
            self.tok[i, 0] = 0
            changed = True
        return changed

    def _chunk_prefill_fn(self, max_start: int):
        """Chunk fn for a dispatch whose deepest cursor is ``max_start``
        tokens: the history walk is bounded by the cursor in pages rounded
        up to a power of two (the reference's compile set)."""
        blocks = -(-max_start // self.page_size)
        hb = 0 if blocks == 0 else min(1 << (blocks - 1).bit_length(),
                                       self.max_blocks)
        fn = self._chunk_prefill_fns.get(hb)
        if fn is None:
            fn = self._chunk_prefill_fns[hb] = make_chunk_prefill_fn(
                self.cfg, hist_blocks=hb)
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
        chunk has the round-robin head's dispatch width; rows finishing
        their prompt draw their first token. Returns requests whose first
        draw was a stop token (finished with empty output)."""
        if not self.prefilling:
            return []
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
        logits, self.state = self._chunk_prefill_fn(int(start.max()))(
            self.params, self._dev(toks), self.state, self._dev(start),
            self._dev(valid), self._dev(mask))
        self.prefill_tokens_computed += int(valid.sum())
        sampled = None
        done: list[Request] = []
        for i in group:
            st = self.prefilling[i]
            st["cursor"] += int(valid[i])
            self.pos[i] = st["cursor"]
            if st["cursor"] == st["S"]:
                if sampled is None:
                    sampled = self._sample_rows(logits)
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

    def _step_paged(self) -> list[Request]:
        if self.state is None:
            self.state = self._init_state(self.batch)
        if self._admit_chunked():
            self._sync_device()
        done = self._advance_prefill()
        active = [i for i, r in enumerate(self.rows)
                  if r is not None and i not in self.prefilling]
        if active:
            row_mask = np.zeros((self.batch,), bool)
            row_mask[active] = True
            done = done + self._decode_tick(active, row_mask)
        if done:
            self._sync_device()
        return done

    # -- introspection -----------------------------------------------------
    def pool_report(self) -> dict:
        """Ticks, token counters and TTFT percentiles; paged, also the page
        occupancy."""
        if not self.paged:
            return {"ticks": self.ticks,
                    "decode_tokens_computed": self.decode_tokens_computed,
                    **self.lifecycle_report()}
        lengths = [int(self.pos[i]) if r is not None else 0
                   for i, r in enumerate(self.rows)]
        a = self.allocator
        allocated = (self.n_pages - 1) - a.n_free
        live = live_page_count(self.tables, lengths, self.page_size)
        return {"kv_cache_dtype": self.kv_cache_dtype,
                "pages_total": self.n_pages - 1,
                "pages_free": a.n_free,
                "pages_allocated": allocated,
                "pages_live": live,
                "utilization": live / max(allocated, 1),
                "ticks": self.ticks,
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "decode_tokens_computed": self.decode_tokens_computed,
                **self.lifecycle_report()}
