"""LLMEngine: the request-lifecycle facade over `ContinuousBatcher` (port
of ``repro.serving.llm_engine``).

Offline ``generate(prompts, sampling_params)`` submits everything, drains
the scheduler and returns final `RequestOutput`s in submission order;
online ``add_request`` / ``step`` / ``abort`` return streaming snapshots
(new-token deltas plus the cumulative stream).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.serving.params import EngineConfig, SamplingParams
from repro_torch.serving.scheduler import ContinuousBatcher, Request


@dataclasses.dataclass
class RequestOutput:
    """One streaming snapshot of a request: ``new_token_ids`` is the delta
    since the previous snapshot, ``token_ids`` the cumulative stream;
    ``metrics`` holds host-clock timestamps, ttft_s and decode_s."""
    uid: int
    new_token_ids: list[int]
    token_ids: list[int]
    finished: bool
    finish_reason: str | None
    metrics: dict


class LLMEngine:
    """Offline `generate` + online `add_request/step/abort` over the
    continuous-batching scheduler, on ``device`` (default "cuda")."""

    def __init__(self, params, cfg, config: EngineConfig | None = None, *,
                 device="cuda"):
        self.config = config or EngineConfig()
        self.batcher = ContinuousBatcher(params, cfg, self.config,
                                         device=device)
        self._live: dict[int, Request] = {}
        self._emitted: dict[int, int] = {}
        self._undelivered: list[RequestOutput] = []
        self._next_uid = 0

    def add_request(self, prompt, sampling_params: SamplingParams | None
                    = None, *, uid: int | None = None,
                    priority: int | None = None) -> int:
        """Queue one request (1-D int token array); returns its uid
        (auto-assigned when None). Default sampling: exact greedy.
        ``priority`` overrides ``sampling_params.priority`` (higher is
        admitted first and preempted last)."""
        sp = sampling_params or SamplingParams.greedy()
        if uid is None:
            while self._next_uid in self.batcher._inflight_uids:
                self._next_uid += 1
            uid = self._next_uid
            self._next_uid += 1
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      sampling=sp, priority=priority)
        self.batcher.submit(req)
        self._live[uid] = req
        self._emitted[uid] = 0
        return uid

    def _snapshot(self, req: Request) -> RequestOutput:
        emitted = self._emitted.get(req.uid, 0)
        toks = list(req.generated)
        self._emitted[req.uid] = len(toks)
        ttft = (req.first_token_time - req.submit_time
                if req.first_token_time is not None
                and req.submit_time is not None else None)
        decode_s = (req.finish_time - req.first_token_time
                    if req.finish_time is not None
                    and req.first_token_time is not None else None)
        out = RequestOutput(
            uid=req.uid, new_token_ids=toks[emitted:], token_ids=toks,
            finished=req.done, finish_reason=req.finish_reason,
            metrics={"submit_time": req.submit_time,
                     "first_token_time": req.first_token_time,
                     "finish_time": req.finish_time,
                     "ttft_s": ttft, "decode_s": decode_s})
        if req.done:
            self._live.pop(req.uid, None)
            self._emitted.pop(req.uid, None)
        return out

    def step(self) -> list[RequestOutput]:
        """One scheduler tick; a snapshot for every request that produced
        tokens or finished."""
        outs, self._undelivered = self._undelivered, []
        self.batcher.step()
        for uid, req in list(self._live.items()):
            if req.done or len(req.generated) > self._emitted.get(uid, 0):
                outs.append(self._snapshot(req))
        return outs

    def abort(self, uid: int) -> RequestOutput | None:
        req = self.batcher.abort(uid)
        return None if req is None else self._snapshot(req)

    def has_unfinished(self) -> bool:
        return bool(self._live)

    def generate(self, prompts: Sequence, sampling_params:
                 SamplingParams | Sequence[SamplingParams] | None = None,
                 *, max_ticks: int = 10_000) -> list[RequestOutput]:
        """Submit every prompt, drain, and return the final snapshot per
        request in submission order."""
        if sampling_params is None or isinstance(sampling_params,
                                                 SamplingParams):
            sps = [sampling_params] * len(prompts)
        else:
            sps = list(sampling_params)
            if len(sps) != len(prompts):
                raise ValueError(f"got {len(sps)} SamplingParams for "
                                 f"{len(prompts)} prompts")
        uids: list[int] = []
        try:
            for p, sp in zip(prompts, sps):
                uids.append(self.add_request(p, sp))
        except Exception:
            for u in uids:       # a rejected prompt aborts its queued peers
                self.abort(u)
            raise
        own = set(uids)
        final: dict[int, RequestOutput] = {}
        for _ in range(max_ticks):
            for out in self.step():
                if out.uid not in own:
                    self._undelivered.append(out)
                elif out.finished:
                    final[out.uid] = out
            if all(u in final for u in uids):
                return [final[u] for u in uids]
        stranded = sorted(u for u in uids if u not in final)
        raise RuntimeError(f"generate: max_ticks={max_ticks} exhausted with "
                           f"requests {stranded} in flight")

    def pool_report(self) -> dict:
        return self.batcher.pool_report()

    @property
    def ticks(self) -> int:
        return self.batcher.ticks
