"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
arXiv:2212.04356).

The conv frontend is a stub, as in the reference: the encoder takes
precomputed (B, T_frames, d_model) frame embeddings (`data.make_frames`).
The transformer backbone is whole: an encoder self-attention stack
(non-causal), and a decoder with causal self-attention and
cross-attention over the encoder output. Norms are LayerNorm, the head
is the tied embedding (``x @ embed.T``). Positions are sinusoidal and
added to the inputs; the shared attention code gets zero positions, so
its RoPE is the identity.

KV-cache quantization sites (the paper's technique):
  * decoder self-attention: the config's contiguous cache (per block),
    one token appended a decode step;
  * cross-attention: K/V computed once from the encoder output at
    prefill and quantized per channel (paper Eq. 5) over the encoder
    length rounded up to 8, zero-padded, with ``length`` set to the true
    encoder length so decode masks the padding.

Parameters: ``embed`` (Vp, d), ``enc_layers`` (norm1, attn, norm2, mlp a
layer), ``dec_layers`` (norm1, self_attn, norm_x, cross_attn, norm2,
mlp), ``enc_norm`` and ``final_norm``. The serving state is a dict of
two lists, one cache a decoder layer: ``self`` and ``cross``, updated in
place.

As in the reference, a decode step adds the float32 sinusoid row to the
embedded token, so the decoder runs that step in float32: the weights
take part promoted to float32 (JAX promotes a bf16 x f32 product; torch
does not, so the port converts each layer's weights as it reaches it).
The prefill stays in the activation dtype.

Under `parallel.shard.mesh_context` (a mesh of ranks) every entry point
takes the global batch and runs this rank's part, as the reference lays
it out under its mesh:

  * the encoder (`encode`, and training's) runs context parallel:
    frames (B, T_enc, d) rows over "batch" and positions over
    "seq_shard" (`parallel.shard.Layout`, replicated where the sizes do
    not divide; the reference's ``act_shard(x, "batch", "seq_shard",
    None)``), the sinusoid taken at this rank's positions, and each
    layer's non-causal attention over K/V gathered along the sequence
    (`attention.train`);
  * training (`forward_train`, ``specs`` the parameters') runs the
    decoder as `transformer.forward_train` runs a decoder stack, with
    its vocab-parallel tied embedding and head; cross-attention takes
    this rank's query positions over the encoder's K/V, projected on the
    encoder's positions and gathered along its sequence
    (`attention.cross_train`). Every block gathers the weights it needs
    inside its checkpoint region;
  * serving (`prefill`, `decode_step`, ``specs`` the serving specs,
    `launch.specs.serve_param_specs`) runs TENSOR PARALLEL on this rank's
    shards alone, over its rows and every position
    (`transformer.serve_layout`): the encoder over all of its rows'
    frames with its heads split (`attention.serve_tp`, non-causal, no
    cache) and its MLPs on their d_ff channels (`mlp.serve`), its output
    whole on every rank of "model"; the decoder's self attention through
    `attention.serve_tp` over this rank's `core.kvcache.ShardedKVCache`
    self slots (`launch.specs.init_serve_state`), its cross attention's
    K/V projected on the rank's kv heads and gathered over them
    (`attention.cross_tp`), each per-channel cross cache's
    `enc_cache_len` slots over "model" prefilled from the whole padded
    encoder K/V (the scales' absmax a MAX all-reduce of the ranks'
    slots) with its ``length`` then set to the true encoder length; a
    decode step gathers q's heads over the rank's cross slots and merges
    the ranks' flat decode partials of both caches in rank order
    (`attention.cross_decode`), still converting each layer's weights
    (now the rank's shards) to float32 as it reaches them; the tied
    embedding and the logits vocab parallel
    (`transformer._embed_sharded`, `transformer.gather_rows_cols`), every
    row's logits out. One device serves through the same functions, on
    specs that keep every leaf whole (`_whole_specs`): each gather is then
    a no-op and each product the plain one.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.tree import tree_map
from repro_torch.models import attention, mlp, transformer
from repro_torch.models.common import embed_init, layernorm, layernorm_init
from repro_torch.models.transformer import check_device, padded_vocab
from repro_torch.parallel.shard import Layout, current_mesh


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 1) float32 positions -> the sinusoid (..., d): the
    reference's float32 expression, row by row."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos / torch.pow(torch.tensor(10000.0, device=pos.device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(S: int, d: int, device, lay=None) -> torch.Tensor:
    """(1, S, d) float32: positions 0..S-1; under a layout ``lay`` (of S
    positions) this rank's positions of it, the same rows."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    sin = _angles(pos, d)[None]
    return sin[:, lay.positions()] if lay is not None and lay.seq else sin


def sinusoid_rows(pos_b: torch.Tensor, d: int) -> torch.Tensor:
    """(B,) int positions -> (B, d) float32: the rows at ``pos_b`` of the
    table the reference builds at every decode step (``_sinusoid(1 << 17,
    d)``), computed alone by the same expression."""
    return _angles(pos_b.float()[:, None], d)


# the reference's stacks of the port's per-layer lists
STACKS = (("enc_blocks", "enc_layers"), ("dec_blocks", "dec_layers"))


def stack_layers(tree, stack=torch.stack) -> dict:
    """The port's layout -> the reference's: ``enc_layers`` and
    ``dec_layers`` as ``enc_blocks`` and ``dec_blocks``, each leaf the
    ``stack`` (default `torch.stack`: on axis 0) of the list of its
    layers' leaves; the other entries unchanged."""
    out = {k: v for k, v in tree.items() if k not in dict(STACKS).values()}
    for ref_key, port_key in STACKS:
        layers = tree[port_key]
        out[ref_key] = tree_map(lambda *xs: stack(list(xs)), layers[0],
                                *layers[1:])
    return out


def _zero_pos(B: int, S: int, device) -> torch.Tensor:
    return torch.zeros((B, S), dtype=torch.int32, device=device)


def _f32(tree):
    return tree_map(lambda t: t.float(), tree)


# -- init ---------------------------------------------------------------------

def _enc_block_init(cfg, gen, device) -> dict:
    return {"norm1": layernorm_init(cfg.d_model, device),
            "attn": attention.init(cfg, gen, device),
            "norm2": layernorm_init(cfg.d_model, device),
            "mlp": mlp.init(cfg, gen, device)}


def _dec_block_init(cfg, gen, device) -> dict:
    return {"norm1": layernorm_init(cfg.d_model, device),
            "self_attn": attention.init(cfg, gen, device),
            "norm_x": layernorm_init(cfg.d_model, device),
            "cross_attn": attention.init(cfg, gen, device),
            "norm2": layernorm_init(cfg.d_model, device),
            "mlp": mlp.init(cfg, gen, device)}


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda", keep=None) -> dict:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a `torch.Generator` on ``device``; None = seed 0).
    ``keep(key, part)``, when given, takes each part as it is made (each
    encoder layer, each decoder layer, the embedding, then the two
    norms; ``key`` its path in the tree) and returns what to hold of it,
    as `transformer.init_params`' hook (`launch.specs.init_shards`)."""
    device = check_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    keep = keep or (lambda key, part: part)
    enc = [keep(("enc_layers", i), _enc_block_init(cfg, generator, device))
           for i in range(cfg.n_encoder_layers)]
    dec = [keep(("dec_layers", i), _dec_block_init(cfg, generator, device))
           for i in range(cfg.n_layers)]
    return {"embed": keep(("embed",), embed_init(
                generator, padded_vocab(cfg), cfg.d_model,
                cfg.activation_dtype, device)),
            "enc_layers": enc, "dec_layers": dec,
            "enc_norm": keep(("enc_norm",),
                             layernorm_init(cfg.d_model, device)),
            "final_norm": keep(("final_norm",),
                               layernorm_init(cfg.d_model, device))}


# -- encoder ------------------------------------------------------------------

def _enc_block(bp, x, cfg, pos, lay=None, sp=None):
    x = x + attention.train(bp["attn"], layernorm(bp["norm1"], x), cfg, pos,
                            causal=False, lay=lay,
                            sp=transformer._sub(sp, "attn"))
    return x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x), lay,
                         transformer._sub(sp, "mlp"))


def _train_layers(cfg, remat, lay=None, sp=None):
    """Training's encoder layer ``(i, bp, x, pos) -> x``: `_enc_block`
    (under ``remat`` in a checkpoint region) in ``lay``, ``sp`` the
    parameters' training specs (None: whole weights)."""
    def layer(i, bp, x, pos):
        args = (bp, x, cfg, pos, lay, None if sp is None
                else sp["enc_layers"][i])
        return (checkpoint(_enc_block, *args, use_reentrant=False)
                if remat else _enc_block(*args))
    return layer


def _serve_layers(cfg, sp, mesh):
    """Serving's encoder layer ``(i, bp, x, pos) -> x`` on this rank's
    shards (``sp`` their serving specs): x this rank's rows at every
    position, each layer's heads (`attention.serve_tp`, non-causal, no
    cache) and d_ff channels (`mlp.serve`) split, the output whole on
    every rank of "model"."""
    def layer(i, bp, x, pos):
        s = sp["enc_layers"][i]
        x = x + attention.serve_tp(bp["attn"], s["attn"],
                                   layernorm(bp["norm1"], x), cfg, pos, None,
                                   "prefill", causal=False, mesh=mesh)
        return x + mlp.serve(bp["mlp"], layernorm(bp["norm2"], x), s["mlp"],
                             mesh)
    return layer


def _encode(params, frames, cfg, layer, lay=None):
    """frames: the whole (B, T_enc, d), or this rank's block of ``lay``
    -> the encoder output in the same layout, ``layer(i, bp, x, pos)``
    running encoder layer i (`_train_layers`, `_serve_layers`)."""
    B, S, d = frames.shape
    dt = cfg.activation_dtype
    sin = _sinusoid(S if lay is None else lay.S, d, frames.device, lay)
    x = frames.to(dt) + sin.to(dt)
    pos = _zero_pos(B, S, frames.device)
    for i, bp in enumerate(params["enc_layers"]):
        x = layer(i, bp, x, pos)
    return layernorm(params["enc_norm"], x)


def encode(params, frames: torch.Tensor, cfg, remat: bool = False, *,
           specs=None):
    """frames (B, T_enc, d) stub embeddings -> encoder output (B, T_enc,
    d) in the activation dtype. With ``remat`` each block keeps only its
    input for the backward. Under a mesh of ranks: frames are the global
    batch, the parameters this rank's shards laid out by ``specs`` (None:
    whole weights), and the result is this rank's block of the output,
    at the rows and positions of ``Layout.of(mesh, B, T_enc, d)``."""
    mesh = current_mesh()
    if mesh is None:
        return _encode(params, frames, cfg, _train_layers(cfg, remat))
    lay = Layout.of(mesh, *frames.shape)
    return _encode(params, frames[lay.rows()][:, lay.positions()], cfg,
                   _train_layers(cfg, remat, lay, specs), lay)


# -- decoder: training --------------------------------------------------------

def _dec_block_train(bp, x, enc_out, cfg, pos, lay=None, sp=None,
                     elay=None):
    x = x + attention.train(bp["self_attn"], layernorm(bp["norm1"], x), cfg,
                            pos, causal=True, lay=lay,
                            sp=transformer._sub(sp, "self_attn"))
    x = x + attention.cross_train(bp["cross_attn"],
                                  layernorm(bp["norm_x"], x), enc_out, cfg,
                                  lay=elay,
                                  sp=transformer._sub(sp, "cross_attn"))
    return x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x), lay,
                         transformer._sub(sp, "mlp"))


def forward_train(params, frames, tokens, cfg, *, remat: bool = True,
                  specs=None):
    """-> (logits (B, S, Vp), aux = 0). frames (B, T_enc, d); tokens (B,
    S) int. Under a mesh of ranks (module docstring): frames and tokens
    are the global batch, the parameters this rank's shards (``specs``
    theirs), and it returns this rank's block of the logits
    (`transformer.logits_spec`) and a zero aux."""
    mesh = current_mesh()
    if mesh is not None:
        if specs is None:
            raise ValueError("forward_train under a mesh needs the "
                             "parameters' specs")
        return _forward_train_sharded(params, specs, frames, tokens, cfg,
                                      mesh, remat)
    enc_out = encode(params, frames, cfg, remat)
    B, S = tokens.shape
    x = params["embed"][tokens]
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    pos = _zero_pos(B, S, x.device)
    for bp in params["dec_layers"]:
        x = (checkpoint(_dec_block_train, bp, x, enc_out, cfg, pos,
                        use_reentrant=False) if remat
             else _dec_block_train(bp, x, enc_out, cfg, pos))
    x = layernorm(params["final_norm"], x)
    return x @ params["embed"].T, torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def _forward_train_sharded(params, sp, frames, tokens, cfg, mesh, remat):
    B, S = tokens.shape
    elay = Layout.of(mesh, *frames.shape)
    enc_out = _encode(params, frames[elay.rows()][:, elay.positions()], cfg,
                      _train_layers(cfg, remat, elay, sp), elay)
    lay = Layout.of(mesh, B, S, cfg.d_model)
    x = transformer._embed_sharded(params, sp, tokens[lay.rows()], cfg, lay)
    x = x + _sinusoid(S, cfg.d_model, x.device, lay).to(x.dtype)
    pos = _zero_pos(*x.shape[:2], x.device)
    for bp, s in zip(params["dec_layers"], sp["dec_layers"]):
        args = (bp, x, enc_out, cfg, pos, lay, s, elay)
        x = (checkpoint(_dec_block_train, *args, use_reentrant=False)
             if remat else _dec_block_train(*args))
    return (transformer._head_sharded(params, sp, x, cfg, lay),
            torch.zeros((), dtype=torch.float32, device=x.device))


# -- decoder: serving ---------------------------------------------------------

def enc_cache_len(cfg) -> int:
    """Cross-cache slots: the encoder length rounded up to 8."""
    return -(-cfg.encoder_seq // 8) * 8


def init_decode_state(cfg, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """One decoder layer each: a self-attention cache (the config's
    granularity, ``max_len`` slots) and a per-channel cross-attention
    cache of `enc_cache_len` slots."""
    device = check_device(device)
    cross_q = dataclasses.replace(cfg.quant, granularity="per_channel")
    return {"self": [QuantizedKVCache.init(
                batch, cfg.n_kv_heads, max_len, cfg.head_dim, cfg.quant,
                device=device) for _ in range(cfg.n_layers)],
            "cross": [QuantizedKVCache.init(
                batch, cfg.n_kv_heads, enc_cache_len(cfg), cfg.head_dim,
                cross_q, device=device) for _ in range(cfg.n_layers)]}


def _pad_t(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[2]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _serve_layout(cfg, B: int, specs):
    """The decoder's layout of a serving step under the active mesh
    (`transformer.serve_layout`), or None without one (a mesh needs the
    shards' ``specs``)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    if specs is None:
        raise ValueError(f"{cfg.name} serves tensor parallel under a mesh: "
                         f"pass its shards' specs "
                         f"(launch.specs.serve_param_specs)")
    return transformer.serve_layout(mesh, cfg, B)


def _whole_specs(params):
    """Every leaf whole: one device serves through the tensor-parallel
    functions on these specs, each gather a no-op (the one-device
    products)."""
    return tree_map(lambda t: ((),) * t.dim(), params)


def prefill(params, frames, tokens, cfg, state, specs=None):
    """Encode the frames, run the prompt through the decoder and fill both
    caches. tokens (B, S) with S a block multiple under per-block caches.
    Returns (logits of the last position (B, Vp), state). Under a mesh
    (module docstring) frames and tokens are the global batch, the
    weights this rank's shards (``specs`` theirs), the state this rank's
    shards, and the logits every row's."""
    B, S = tokens.shape
    lay = _serve_layout(cfg, B, specs)
    if lay is None:
        mesh, specs = None, _whole_specs(params)
    else:
        mesh = lay.mesh
        frames, tokens = frames[lay.rows()], tokens[lay.rows()]
    enc_out = _encode(params, frames, cfg, _serve_layers(cfg, specs, mesh))
    x = params["embed"][tokens] if lay is None else \
        transformer._embed_sharded(params, specs, tokens, cfg, lay)
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    pos = _zero_pos(*tokens.shape, x.device)
    for bp, sp, self_c, cross_c in zip(params["dec_layers"],
                                       specs["dec_layers"], state["self"],
                                       state["cross"]):
        x = x + attention.serve_tp(bp["self_attn"], sp["self_attn"],
                                   layernorm(bp["norm1"], x), cfg, pos,
                                   self_c, "prefill", mesh=mesh)
        h, (ck, cv) = attention.cross_tp(bp["cross_attn"], sp["cross_attn"],
                                         layernorm(bp["norm_x"], x), enc_out,
                                         cfg, mesh)
        cross_c.prefill(_pad_t(ck.float(), cross_c.max_len),
                        _pad_t(cv.float(), cross_c.max_len))
        cross_c.length = ck.shape[2]            # masks the padding
        x = x + h
        x = x + mlp.serve(bp["mlp"], layernorm(bp["norm2"], x), sp["mlp"],
                          mesh)
    return transformer._logits(params, x[:, -1], cfg, lay, specs), state


def decode_step(params, token, cfg, state, pos_b, specs=None):
    """token (B, 1), pos_b (B,) absolute positions -> (logits (B, Vp)
    float32, state). Under a mesh: the global batch in, this rank's rows
    run over its shards of the weights (``specs`` theirs) and of the
    caches, every row's logits out."""
    B = token.shape[0]
    lay = _serve_layout(cfg, B, specs)
    if lay is None:
        mesh, specs = None, _whole_specs(params)
        x = params["embed"][token]
    else:
        mesh = lay.mesh
        token, pos_b = token[lay.rows()], pos_b[lay.rows()]
        x = transformer._embed_sharded(params, specs, token, cfg, lay)
    x = x + sinusoid_rows(pos_b, cfg.d_model)[:, None]
    pos = _zero_pos(token.shape[0], 1, x.device)
    for bp, sp, self_c, cross_c in zip(params["dec_layers"],
                                       specs["dec_layers"], state["self"],
                                       state["cross"]):
        bp = _f32(bp)
        x = x + attention.serve_tp(bp["self_attn"], sp["self_attn"],
                                   layernorm(bp["norm1"], x), cfg, pos,
                                   self_c, "decode", mesh=mesh)
        x = x + attention.cross_decode(bp["cross_attn"], sp["cross_attn"],
                                       layernorm(bp["norm_x"], x), cfg,
                                       cross_c, mesh)
        x = x + mlp.serve(bp["mlp"], layernorm(bp["norm2"], x), sp["mlp"],
                          mesh)
    x = layernorm(params["final_norm"], x[:, -1])
    logits = x @ params["embed"].float().T
    if lay is None:
        return logits, state
    return transformer.gather_rows_cols(logits, lay.batch,
                                        specs["embed"][0], mesh), state
