"""Batched token selection: per-row temperature / top-k / top-p with
per-request PRNG streams (port of ``repro.models.sampling``).

Everything is vectorized logit math over a (B, V) batch on the logits'
device: no per-row Python and no host sync, so rows with mixed settings
share one decode step. Rows with ``temperature <= 0`` take the exact argmax
of the raw logits (first index on ties, as ``jnp.argmax``), so a greedy row
is bitwise unaffected by sampled neighbours.

Token ``i`` of a request is drawn with ``fold_in(base_key, i)``
(`models.prng`), so a seeded request's stream depends only on its seed and
the token index, never on the batch or the chunking.
"""
from __future__ import annotations

import torch

from repro_torch.models import prng

_NEG = -1e30                    # mask value: exp() underflows to exact 0


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Argmax over the real vocabulary: logits (B, Vp) -> (B,) int32."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


def fold_keys(base_keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-row step keys: fold token index ``steps[i]`` into row i's base
    key. base_keys (B, 2) int64 words, steps (B,) int -> (B, 2)."""
    return prng.fold_in(base_keys, steps)


def _filter_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Top-k, then nucleus (top-p), from ONE shared full-vocabulary sort.

    Top-k masks logits below each row's k-th largest (top_k 0 keeps all;
    ties at the threshold are kept). The masked logits' descending order
    is the sorted tail masked the same way, so the nucleus filter (the
    smallest descending-probability prefix whose mass reaches top_p;
    always >= 1 token) needs no second sort. The nucleus cut is taken in
    logit space at a member of the masked logits."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    kth = torch.gather(sorted_desc, -1,
                       torch.clamp(k - 1, 0, V - 1).long()[:, None])
    neg = torch.full_like(scaled, _NEG)
    masked = torch.where(scaled < kth, neg, scaled)
    sorted_masked = torch.where(sorted_desc < kth, neg, sorted_desc)
    e = torch.exp(sorted_masked - sorted_masked.amax(-1, keepdim=True))
    ps = e / e.sum(-1, keepdim=True)                   # descending probs
    cum = torch.cumsum(ps, dim=-1)
    p = torch.clamp(top_p, 1e-9, 1.0)[:, None]
    keep = (cum - ps) < p          # kept if the mass BEFORE it is < p
    n_keep = torch.clamp_min(keep.sum(-1), 1)
    thresh = torch.gather(sorted_masked, -1, (n_keep - 1)[:, None])
    return torch.where(masked < thresh, neg, masked)


def sample(logits: torch.Tensor, vocab: int, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           keys: torch.Tensor) -> torch.Tensor:
    """Draw one token per row. logits (B, Vp) any float dtype; ``vocab``
    trims the head's padding; temperature / top_k / top_p (B,); keys
    (B, 2) per-row step keys. Returns (B,) int32."""
    lg = logits[..., :vocab].float()
    greedy_tok = torch.argmax(lg, dim=-1).to(torch.int32)
    scaled = lg / torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = _filter_logits(scaled, top_k, top_p)
    drawn = prng.categorical(keys, scaled).to(torch.int32)
    return torch.where(temperature > 0, drawn, greedy_tok)


def sample_at_step(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   base_key: torch.Tensor, step: torch.Tensor, *,
                   vocab: int) -> torch.Tensor:
    """`sample` with token index ``step[i]`` of row i drawn with
    ``fold_in(base_key[i], step[i])``: the one entry point of the decode
    scan, the per-token tick and the first token after prefill."""
    return sample(logits, vocab, temperature, top_k, top_p,
                  fold_keys(base_key, step))


def device_arrays(arrays: dict, device) -> dict:
    """`serving.params.sampling_arrays`'s numpy arrays as tensors on
    ``device`` (keys as int64 words), one copy per array."""
    out = {k: torch.as_tensor(v, device=device)
           for k, v in arrays.items() if k != "key"}
    out["key"] = torch.as_tensor(arrays["key"].astype("int64"),
                                 device=device)
    return out
