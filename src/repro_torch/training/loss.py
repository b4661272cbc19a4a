"""Next-token cross-entropy (port of ``repro.training.loss``), and its
vocab-parallel form under a mesh."""
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


def next_token_loss_sharded(logits: torch.Tensor, labels: torch.Tensor,
                            vocab: int, lay, vocab_axes: tuple,
                            n_labels) -> torch.Tensor:
    """This rank's share of `next_token_loss` under a mesh (the shares of
    all ranks sum to the loss). logits (B_l, S, V_l): this rank's rows of
    the batch (``lay``) and its V_l columns of the padded vocab, the
    columns split over ``vocab_axes``; labels (B_l, S) the same rows;
    ``n_labels`` the count of labels >= 0 over the whole batch. The
    running max and the log-sum-exp are all-reduced over the vocab axes,
    the gold logit comes from the rank that owns its column, pad columns
    (>= vocab) are masked on the ranks that own them, and each rank's sum
    is divided by the ranks that hold the same rows."""
    from repro_torch.parallel.shard import all_reduce
    mesh = lay.mesh
    logits = logits.float()
    Vl = logits.shape[-1]
    lo = mesh.index(vocab_axes)[0] * Vl if vocab_axes else 0
    col = lo + torch.arange(Vl, device=logits.device)
    logits = logits.masked_fill(col >= vocab, -1e30)
    m = torch.amax(logits, dim=-1).detach()
    if vocab_axes:
        m = mesh.all_reduce(m, vocab_axes, "max")
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    labels = labels.to(device=logits.device, dtype=torch.int64)
    idx = torch.clamp_min(labels, 0) - lo
    own = (idx >= 0) & (idx < Vl)
    gold = torch.gather(logits, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = torch.where(own, gold, torch.zeros_like(gold))
    if vocab_axes:
        se = all_reduce(se, vocab_axes, mesh)
        gold = all_reduce(gold, vocab_axes, mesh)
    nll = m + torch.log(se) - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / max(float(n_labels), 1.0) / lay.rep
