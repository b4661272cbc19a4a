"""Decoder-only models for training and serving (port of
``repro.models.transformer``).

Block kinds (``cfg.block_kind(i)``), as the reference's:
    attn        pre-norm GQA attention + pre-norm SwiGLU MLP
    local_attn  the same, sliding-window attention
    moe         pre-norm GQA attention + pre-norm MoE FFN
    rglru       pre-norm RG-LRU mixer + pre-norm SwiGLU MLP (`models.rglru`)
    mlstm/slstm xLSTM mixers (`models.xlstm`; no FFN when cfg.d_ff == 0)

Parameters are a dict: ``embed`` (Vp, d), ``lm_head`` (d, Vp; none with
tied embeddings, whose head is ``embed.T``), ``final_norm``, and
``layers`` — one dict per layer (norm1, the mixer
under its kind's name, then norm2 with mlp or moe where the kind has an
FFN). The reference stacks layers by pattern position on a leading axis
for ``lax.scan`` (``blocks.p{i}``, plus an unstacked ``tail``); the port
keeps a list and loops over layers, and `decode_scan` over its
steps (`decode_scan_step`, in place on a carry whose indices live on the
device). On the card the paged server captures a decode step, one step of
a scan, or a prompt chunk as one CUDA graph and replays it, a scan's step
once per step (`serving.dispatch`, the counterpart of the reference's
jit); the functions here are what it captures. The serving state is a
list with one entry per layer: for an attention kind a contiguous
`QuantizedKVCache` (the default; a ring under a sliding window) or a
paged `PagedQuantizedKVCache`, for a recurrent kind its state
(`rglru.RGLRUState`, `xlstm.MLSTMState`, `xlstm.SLSTMState`), updated in
place like the caches. Norms are RMSNorm or LayerNorm by ``cfg.norm``;
positions rotate queries and keys by RoPE, or by M-RoPE in text mode
where the config has sections (qwen2_vl_2b). The paged backend takes
full-attention stacks only, as the reference's. An encoder-decoder
(whisper_small) is `models.encdec`, not this module.
`forward_train` recomputes each block in the backward
(`torch.utils.checkpoint`), as the reference's per-block
``jax.checkpoint(nothing_saveable)``.

Under `parallel.shard.mesh_context` (a mesh of ranks), `forward_train`
takes the global batch and runs this rank's part of it: parameters are
shards, laid out by the ``specs`` passed in (`launch.specs.param_specs`),
activations between blocks are (batch over "pod" / "data", sequence
over "model") where
`logical_spec` says the sizes divide (`parallel.shard.Layout`), and each
block gathers, inside its checkpoint region, the weights its compute
needs (so the recompute gathers again and the backward reduce-scatters
the gradients). The embedding is vocab-parallel (the rows this "model"
rank lacks are zero, then a reduce-scatter along the sequence), and so
are the logits. The attention, MLP and MoE blocks serve under a mesh;
the recurrent kinds and the encoder-decoder wait for ROADMAP item 15
(`check_distributable`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quantization as Q
from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.paging import PagedQuantizedKVCache
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import attention, mlp, moe, rglru, xlstm
from repro_torch.models import sampling as SMP
from repro_torch.models.common import (dense_init, embed_init, layernorm,
                                       layernorm_init, rmsnorm, rmsnorm_init)
from repro_torch.parallel.shard import (Layout, current_mesh, gather_param,
                                        logical_spec)


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab // 128) * 128


def check_device(device) -> torch.device:
    """The entry points' device rule: the device asked for, or an error —
    never a silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "kernels' plain PyTorch versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


ATTN_KINDS = ("attn", "local_attn", "moe")


def check_servable(cfg, *, paged: bool = False) -> None:
    """What this module serves: decoder stacks of any of the reference's
    block kinds (RMSNorm or LayerNorm, RoPE or M-RoPE, tied embeddings or
    a head of their own), on the contiguous backend; with ``paged``,
    full-attention stacks without a sliding window only, refused with the
    reference's `ValueError` as its paged backend refuses them. An
    encoder-decoder config raises `ValueError`: it needs frames, which
    these entry points (and the batchers and `generate` above them) do
    not take, as the reference's do not; `serving.engine.make_serve_fns`
    serves it (`models.encdec`)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: its prefill needs "
            f"frames, which the decoder-only entry points, the batchers "
            f"and generate do not feed (the reference's batcher fails on "
            f"the missing 'frames'); serve it through "
            f"serving.engine.make_serve_fns with batch_inputs "
            f"{{'frames', 'tokens'}}")
    if paged:
        bad = [k for k in cfg.block_pattern if k not in ("attn", "moe")]
        if bad or cfg.sliding_window:
            raise ValueError(
                f"paged serving supports full-attention stacks only "
                f"(got kinds={bad or cfg.block_pattern}, "
                f"sliding_window={cfg.sliding_window})")


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda", keep=None) -> dict:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a `torch.Generator` on ``device``; None = seed 0).
    ``keep(key, part)``, when given, takes each part as it is made (the
    embedding, the final norm, the head, then each layer, ``key`` its
    path in the tree) and returns what to hold of it: a rank of a mesh
    keeps its shards (`launch.specs.init_shards`)."""
    device = check_device(device)
    check_servable(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    keep = keep or (lambda key, part: part)
    Vp, dt = padded_vocab(cfg), cfg.activation_dtype
    params = {
        "embed": keep(("embed",), embed_init(generator, Vp, cfg.d_model, dt,
                                             device)),
        "final_norm": keep(("final_norm",), norm_init(cfg, device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), dense_init(
            generator, cfg.d_model, Vp, dt, device))
    params["layers"] = []
    for i in range(cfg.n_layers):
        params["layers"].append(keep(("layers", i), _block_init(
            cfg, cfg.block_kind(i), generator, device)))
    return params


def norm_init(cfg, device) -> dict:
    """A norm's parameters by ``cfg.norm``."""
    return (rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init)(
        cfg.d_model, device)


def norm(cfg, p, x):
    """RMSNorm or LayerNorm by ``cfg.norm``, as the reference's ``_norm``."""
    return (rmsnorm if cfg.norm == "rmsnorm" else layernorm)(p, x)


def _block_init(cfg, kind: str, gen, device) -> dict:
    """One layer's parameters, as the reference's ``_block_init``."""
    p = {"norm1": norm_init(cfg, device)}
    if kind in ATTN_KINDS:
        p["attn"] = attention.init(cfg, gen, device)
    elif kind == "rglru":
        p["rglru"] = rglru.init(cfg, gen, device)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(cfg, gen, device)
    elif kind == "slstm":
        p["slstm"] = xlstm.slstm_init(cfg, gen, device)
    else:
        raise ValueError(kind)
    if kind == "moe":
        p["norm2"] = norm_init(cfg, device)
        p["moe"] = moe.init(cfg, gen, device)
    elif kind in ("attn", "local_attn", "rglru") and cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg, device)
        p["mlp"] = mlp.init(cfg, gen, device)
    return p


def init_decode_state(cfg, batch: int, max_len: int, *, paged: bool = False,
                      n_pages: int | None = None, kv_cache_dtype="int8",
                      device="cuda") -> list:
    """One entry per layer, by its kind: for attention a contiguous
    `QuantizedKVCache` (int8 only; a ring of the window's block-rounded
    length under a sliding window shorter than ``max_len``), or with
    ``paged=True`` a paged cache over its own pool of ``n_pages`` pages
    (default: dense capacity, batch * max_len / page + sentinel); for
    rglru, mlstm and slstm the recurrent state (`rglru.init_state`,
    `xlstm.mlstm_init_state` without state_quant, `xlstm.slstm_init_state`).
    ``kv_cache_dtype`` is any spec `Q.resolve_kv_dtype_spec` takes (a
    dtype string, a `PrecisionPlan`, a plan dict or JSON path, a per-layer
    sequence); layer l's pool stores ``layer_kv_dtypes(spec, L)[l]``.
    ``paged=True`` on a stack with other kinds or a sliding window raises
    the reference's `ValueError`."""
    device = check_device(device)
    check_servable(cfg, paged=paged)
    spec = Q.resolve_kv_dtype_spec(kv_cache_dtype, n_layers=cfg.n_layers)
    layer_dts = Q.layer_kv_dtypes(spec, cfg.n_layers)
    if not paged:
        if any(dt != "int8" for dt in layer_dts):
            raise ValueError(f"kv_cache_dtype={spec!r} requires the paged "
                             f"cache (the contiguous backends are "
                             f"int8-only)")
        eff = max_len
        if cfg.sliding_window:
            eff = min(max_len, _round_block(cfg.sliding_window, cfg))

        def one(kind):
            if kind in ATTN_KINDS:
                return QuantizedKVCache.init(batch, cfg.n_kv_heads, eff,
                                             cfg.head_dim, cfg.quant,
                                             ring=eff < max_len,
                                             device=device)
            if kind == "rglru":
                return rglru.init_state(cfg, batch, device)
            if kind == "mlstm":
                return xlstm.mlstm_init_state(cfg, batch, state_quant=False,
                                              device=device)
            return xlstm.slstm_init_state(cfg, batch, device=device)
        return [one(cfg.block_kind(i)) for i in range(cfg.n_layers)]
    if n_pages is None:
        n_pages = batch * (max_len // cfg.quant.block_size) + 1
    return [PagedQuantizedKVCache.init(
        batch, cfg.n_kv_heads, max_len, cfg.head_dim, cfg.quant,
        n_pages=n_pages, kv_dtype=dt, device=device) for dt in layer_dts]


def pattern_layout(cfg) -> tuple[int, int, int]:
    """(period, n_groups, tail) of the reference's stacked layout: layer
    g * period + i is ``blocks.p{i}[g]``, layer n_groups * period + j is
    ``tail[j]``."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    return period, n_groups, cfg.n_layers - n_groups * period


def stack_layers(tree, period: int = 1, stack=torch.stack) -> dict:
    """The port's layout (``layers``: one dict per layer) -> the
    reference's: ``blocks.p{i}`` for i < ``period``, each leaf the
    ``stack`` (default `torch.stack`: on axis 0) of the list of its n_groups
    = len(layers) // period layers' leaves, and the remaining layers
    unstacked under ``tail`` (a key only when there is a tail); the other
    top-level entries unchanged."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    n_groups = len(layers) // period
    out["blocks"] = {}
    for i in range(period):
        pos = layers[i:n_groups * period:period]
        out["blocks"][f"p{i}"] = tree_map(lambda *xs: stack(list(xs)),
                                          pos[0], *pos[1:])
    if len(layers) > n_groups * period:
        out["tail"] = list(layers[n_groups * period:])
    return out


def unstack_layers(tree) -> dict:
    """Inverse of `stack_layers` (the layers are views of the stack; a
    ``tail``'s layers follow the groups)."""
    out = {k: v for k, v in tree.items() if k not in ("blocks", "tail")}
    blocks = tree["blocks"]
    period = len(blocks)
    n = leaves(blocks["p0"])[0].shape[0]
    out["layers"] = [tree_map(lambda x, g=g: x[g], blocks[f"p{i}"])
                     for g in range(n) for i in range(period)]
    out["layers"] += list(tree.get("tail") or [])
    return out


# -- training -----------------------------------------------------------------

def _embed(params, tok, cfg, positions):
    """tokens (B, S), or embeddings (B, S, d) when ``cfg.embedding_inputs``
    -> (x (B, S, d), positions (B, S) int32; 0..S-1 when None)."""
    if cfg.embedding_inputs and tok.dim() == 3:
        x = tok.to(cfg.activation_dtype)
    else:
        x = params["embed"][tok]
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    return x, positions


def check_distributable(cfg, mesh) -> bool:
    """Whether training runs sharded on ``mesh`` (None: no mesh). The
    attention kinds do; a stack with rglru, mlstm or slstm blocks, or an
    encoder-decoder, raises `ValueError` on a mesh of several ranks and
    runs its one-device path on a mesh of one."""
    if mesh is None:
        return False
    other = sorted({k for k in cfg.block_pattern if k not in ATTN_KINDS})
    if cfg.family == "encdec" or other:
        if mesh.size > 1:
            what = "an encoder-decoder" if cfg.family == "encdec" else \
                f"{'/'.join(other)} blocks"
            raise ValueError(
                f"{cfg.name}: {what} under a mesh of {mesh.size} ranks "
                f"wait for ROADMAP item 15 (the reference shards their "
                f"batch over the idle model axis and lays out "
                f"cross-attention apart); train them on one rank")
        return False
    return True


def _sub(sp, key):
    return None if sp is None else sp[key]


def _block_train(p, x, kind: str, cfg, positions, lay=None, sp=None):
    """One layer over the whole sequence: its mixer by kind, the residual,
    then its FFN. Returns (x, the MoE's aux loss, 0 for other kinds).
    Under a mesh x is this rank's part of ``lay``, ``sp`` the layer's
    specs, and aux this rank's share."""
    h = norm(cfg, p["norm1"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        h = attention.train(p["attn"], h, cfg, positions,
                            local=kind == "local_attn", lay=lay,
                            sp=_sub(sp, "attn"))
    elif kind == "rglru":
        h, _ = rglru.apply_seq(p["rglru"], h, cfg)
    elif kind == "mlstm":
        h, _ = xlstm.mlstm_seq(p["mlstm"], h, cfg)
    elif kind == "slstm":
        h, _ = xlstm.slstm_seq(p["slstm"], h, cfg)
    x = x + h
    if "moe" in p:
        h2, aux = moe.apply(p["moe"], norm(cfg, p["norm2"], x), cfg, lay,
                            _sub(sp, "moe"))
        x = x + h2
    elif "mlp" in p:
        x = x + mlp.apply(p["mlp"], norm(cfg, p["norm2"], x), lay,
                          _sub(sp, "mlp"))
    return x, aux


def _embed_sharded(params, sp, tok, cfg, lay):
    """This rank's rows of tokens (B_l, S) (or embeddings (B_l, S, d))
    -> x in ``lay``: a vocab-parallel lookup into the embedding gathered
    over its FSDP axes (rows of other "model" ranks zero), summed over the
    vocab axes onto the sequence shards."""
    if cfg.embedding_inputs and tok.dim() == 3:
        return lay.to_layout(tok.to(cfg.activation_dtype), ())
    vax = sp["embed"][0]
    E = gather_param(params["embed"], sp["embed"], lay.mesh, keep=vax)
    if not vax:
        return lay.to_layout(E[tok], ())
    Vl = E.shape[0]
    idx = tok.to(torch.int64) - lay.mesh.index(vax)[0] * Vl
    own = (idx >= 0) & (idx < Vl)
    x = torch.where(own[..., None], E[idx.clamp(0, Vl - 1)],
                    torch.zeros((), dtype=E.dtype, device=E.device))
    return lay.to_layout(x, vax)


def _head_sharded(params, sp, x, cfg, lay):
    """x in ``lay`` -> this rank's logits (B_l, S, Vp / n): the final norm
    on the sequence shards, the sequence gathered, and the product with
    this rank's vocab columns of the head (FSDP shards gathered)."""
    x = lay.whole_seq(norm(cfg, params["final_norm"], x))
    if cfg.tie_embeddings:
        e = sp["embed"]
        return x @ gather_param(params["embed"], e, lay.mesh, keep=e[0]).T
    h = sp["lm_head"]
    return x @ gather_param(params["lm_head"], h, lay.mesh, keep=h[1])


def logits_spec(cfg, B: int, S: int, mesh) -> tuple:
    """The layout of the training logits (B, S, Vp): rows over "batch",
    vocab over "vocab" (the reference's ``act_shard(logits, "batch",
    None, "vocab")``)."""
    return logical_spec(("batch", None, "vocab"), (B, S, padded_vocab(cfg)),
                        mesh)


def _forward_train_sharded(params, sp, tok, cfg, mesh, positions, remat):
    B, S = tok.shape[:2]
    lay = Layout.of(mesh, B, S, cfg.d_model)
    rows, cols = lay.rows(), lay.positions()
    x = _embed_sharded(params, sp, tok[rows], cfg, lay)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    positions = positions[rows][..., cols]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, s) in enumerate(zip(params["layers"], sp["layers"])):
        args = (p, x, cfg.block_kind(i), cfg, positions, lay, s)
        x, a = (checkpoint(_block_train, *args, use_reentrant=False)
                if remat else _block_train(*args))
        aux = aux + a
    return _head_sharded(params, sp, x, cfg, lay), aux


def forward_train(params, tokens_or_embeds, cfg, *, positions=None,
                  remat: bool = True, specs=None):
    """-> (logits (B, S, Vp), aux_loss ()): every block kind, as the
    reference's. tokens (B, S) int, or embeddings (B, S, d) when
    ``cfg.embedding_inputs``; aux is the sum of the MoE blocks' load
    balancing losses (0 without them). With ``remat`` each block keeps
    only its input for the backward and runs its forward again there
    (flash attention's kernel included).

    Under a mesh of ranks (module docstring): tokens (B, S) or embeddings
    are the GLOBAL batch, the parameters this rank's shards (``specs``
    theirs), and it returns this rank's block of the logits
    (`logits_spec`) and its share of aux (the shares of all ranks sum to
    aux)."""
    mesh = current_mesh()
    if check_distributable(cfg, mesh):
        if specs is None:
            raise ValueError("forward_train under a mesh needs the "
                             "parameters' specs")
        return _forward_train_sharded(params, specs, tokens_or_embeds, cfg,
                                      mesh, positions, remat)
    x, positions = _embed(params, tokens_or_embeds, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        kind = cfg.block_kind(i)
        if remat:
            x, a = checkpoint(_block_train, p, x, kind, cfg, positions,
                              use_reentrant=False)
        else:
            x, a = _block_train(p, x, kind, cfg, positions)
        aux = aux + a
    return _head(params, x, cfg), aux


# -- serving ------------------------------------------------------------------

def _round_block(n: int, cfg) -> int:
    """``n`` rounded up to the cache block (8 in per_channel mode)."""
    b = cfg.quant.block_size if cfg.quant.granularity == "per_block" else 8
    return -(-n // b) * b


def _block_serve(p, x, kind: str, cfg, positions, cache, mode: str,
                 row_mask=None, hist_blocks=None, valid=None):
    """One layer over x (B, S, d): its mixer by kind (the cache or the
    recurrent state updated in place), the residual, then its FFN."""
    h = norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS:
        local = kind == "local_attn"
        if mode == "prefill":
            h, cache = attention.prefill(p["attn"], h, cfg, positions, cache,
                                         local=local, row_mask=row_mask)
        elif mode == "chunk":
            h, cache = attention.prefill_chunk(p["attn"], h, cfg, positions,
                                               cache, row_mask=row_mask,
                                               hist_blocks=hist_blocks,
                                               valid=valid)
        elif mode == "decode":
            h, cache = attention.decode(p["attn"], h, cfg, positions, cache,
                                        local=local, row_mask=row_mask)
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
    else:
        if mode not in ("prefill", "decode"):
            raise ValueError(f"{kind} blocks serve prefill and decode only "
                             f"(got mode {mode!r})")
        seq = mode == "prefill"
        if kind == "rglru":
            h, new = (rglru.apply_seq(p["rglru"], h, cfg) if seq else
                      rglru.apply_step(p["rglru"], h, cfg, cache))
        elif kind == "mlstm":
            h, new = (xlstm.mlstm_seq(p["mlstm"], h, cfg) if seq else
                      xlstm.mlstm_step(p["mlstm"], h, cfg, cache))
        else:
            h, new = (xlstm.slstm_seq(p["slstm"], h, cfg) if seq else
                      xlstm.slstm_step(p["slstm"], h, cfg, cache))
        cache.copy_(new)
    x = x + h.to(x.dtype)
    if "moe" in p:
        return x + moe.apply(p["moe"], norm(cfg, p["norm2"], x), cfg)[0]
    if "mlp" in p:
        return x + mlp.apply(p["mlp"], norm(cfg, p["norm2"], x))
    return x


def _serve(params, tok, cfg, state, positions, mode: str, row_mask=None,
           hist_blocks=None, valid=None):
    """Run every layer over tokens (B, S); returns the final hidden states
    (B, S, d) — the head is applied by the caller, only where it reads
    logits (the same numbers as the reference's all-position head)."""
    x = params["embed"][tok]
    for i, (p, cache) in enumerate(zip(params["layers"], state)):
        x = _block_serve(p, x, cfg.block_kind(i), cfg, positions, cache,
                         mode, row_mask, hist_blocks, valid)
    return x


def _head(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return norm(cfg, params["final_norm"], x) @ w


def prefill(params, tokens, cfg, state, *, positions=None, row_mask=None):
    """Prompt pass over the contiguous caches: tokens (B, S) at positions
    0..S-1 (default). Returns (logits of the last position (B, Vp),
    state)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = _serve(params, tokens, cfg, state, positions, "prefill", row_mask)
    return _head(params, x[:, -1], cfg), state


def prefill_chunk(params, tokens, cfg, state, *, start, row_mask=None,
                  hist_blocks=None, valid=None):
    """One varlen chunked-prefill step: ``tokens`` (B, C) int (C a page
    multiple), ``start`` (B,) each row's page-aligned resident token count,
    ``valid`` (B,) true tokens per row (None = C). Returns (logits (B, Vp)
    at each row's last valid position, state)."""
    C = tokens.shape[1]
    positions = start[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=tokens.device)[None]
    x = _serve(params, tokens, cfg, state, positions, "chunk", row_mask,
               hist_blocks, valid)
    if valid is None:
        last = x[:, -1]
    else:
        idx = torch.clamp_min(valid.to(torch.int64) - 1, 0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
    return _head(params, last, cfg), state


def decode_step(params, token, cfg, state, pos, *, row_mask=None):
    """One decode step: token (B, 1), pos (B,) current positions. Returns
    (logits (B, Vp), state)."""
    positions = pos[:, None].to(torch.int32)
    x = _serve(params, token, cfg, state, positions, "decode", row_mask)
    return _head(params, x[:, -1], cfg), state


def scan_carry(token, pos, steps: int) -> dict:
    """The loop state of a decode scan of ``steps`` steps, on ``token``'s
    device: ``tok`` (B, 1) the pending token and ``pos`` (B,) its position
    (copies of the arguments), ``emitted`` (steps, B) the tokens fed and
    ``j`` (1,) the step index."""
    B = token.shape[0]
    return {"tok": token.to(torch.int32).clone(),
            "pos": pos.to(torch.int32).clone(),
            "emitted": torch.empty((steps, B), dtype=torch.int32,
                                   device=token.device),
            "j": torch.zeros((1,), dtype=torch.int64, device=token.device)}


def decode_scan_step(params, cfg, state, carry, *, row_mask=None,
                     sampling=None):
    """One step of `decode_scan`, in place on ``carry`` (`scan_carry`):
    feeds ``tok`` at ``pos`` and writes it into row ``j`` of ``emitted``,
    draws the next pending token into ``tok`` (greedy, or from
    ``sampling`` at its ``step``), then advances ``pos``, ``j`` and
    ``sampling["step"]`` by one. Returns the state. Every index it takes
    lives on the device, so one captured step replays as every step of a
    scan."""
    tok = carry["tok"]
    logits, state = decode_step(params, tok, cfg, state, carry["pos"],
                                row_mask=row_mask)
    carry["emitted"].index_copy_(0, carry["j"], tok.view(1, -1))
    if sampling is None:
        nxt = SMP.greedy(logits, cfg.vocab)
    else:
        nxt = SMP.sample_at_step(
            logits, sampling["temperature"], sampling["top_k"],
            sampling["top_p"], sampling["key"], sampling["step"],
            vocab=cfg.vocab)
        sampling["step"].add_(1)
    tok.copy_(nxt.view(-1, 1))
    carry["pos"].add_(1)
    carry["j"].add_(1)
    return state


def decode_scan(params, token, cfg, state, pos, *, steps: int,
                row_mask=None, sampling=None):
    """Decode ``steps`` tokens. ``token`` (B, 1) is the pending token
    (sampled, not yet fed), ``pos`` (B,) its position. Returns (pending
    (B, 1), state, emitted (steps, B)): emitted[j] is the token fed at step
    j. ``sampling=None`` is greedy argmax (first index on ties); otherwise
    a dict of per-row tensors on the card — temperature, top_k, top_p,
    key (B, 2) base keys and step (B,) the index of each row's next token
    (`models.sampling.device_arrays`) — and step j of row i draws with
    ``fold_in(key[i], step[i] + j)``. The arguments are left as passed:
    the steps (`decode_scan_step`) advance copies."""
    carry = scan_carry(token, pos, steps)
    if sampling is not None:
        sampling = dict(sampling, step=sampling["step"].clone())
    for _ in range(steps):
        state = decode_scan_step(params, cfg, state, carry,
                                 row_mask=row_mask, sampling=sampling)
    return carry["tok"], state, carry["emitted"]
