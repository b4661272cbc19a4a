"""Token selection (port of ``repro.models.sampling``, greedy arm only).

Rows with temperature 0 take the exact argmax of the logits (first index
on ties, as ``jnp.argmax``). Sampled rows need the reference's seeded
threefry2x32 stream to reproduce its tokens; that port is ROADMAP queue
1, item 6, and until then a sampled row raises.
"""
from __future__ import annotations

import numpy as np
import torch


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Argmax over the real vocabulary: logits (B, Vp) -> (B,) int32."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


def sample_at_step(logits: torch.Tensor, temperature, *, vocab: int
                   ) -> torch.Tensor:
    """Next token per row: logits (B, Vp), temperature (B,) host values ->
    (B,) int32."""
    if np.any(np.asarray(temperature) > 0):
        raise NotImplementedError(
            "temperature > 0 needs the threefry sampler port "
            "(ROADMAP queue 1, item 6)")
    return greedy(logits, vocab)
