"""Next-token cross-entropy (port of ``repro.training.loss``)."""
from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """logits (B, S, Vp) float32/bfloat16; labels (B, S) int. Positions
    with label < 0 are masked; pad-vocab columns (>= vocab) are set to
    -1e30, so they take no probability. Returns the mean over the
    unmasked positions, float32."""
    Vp = logits.shape[-1]
    logits = logits.float()
    if Vp > vocab:
        pad = torch.arange(Vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.to(device=logits.device, dtype=torch.int64)
    gold = torch.gather(logits, -1, torch.clamp_min(labels, 0)[..., None])
    nll = logz - gold[..., 0]
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
