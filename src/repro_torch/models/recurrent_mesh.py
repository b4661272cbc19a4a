"""The recurrent blocks (RG-LRU, mLSTM, sLSTM) under a mesh of ranks:
the layouts they train and serve in (the reference leaves them to GSPMD
under its mesh; ``repro.models.rglru`` constrains u to ("batch", "seq",
"ffn")).

Between blocks the activations are (rows over "batch", positions over
"seq_shard") (`parallel.shard.Layout`); a recurrence needs every
position of its rows, so each block gathers the sequence over
"seq_shard" first and returns its output to the layout after: a
hybrid stack (recurrentgemma_9b) changes layout at every change of kind,
its local attention running context parallel in between
(`models.attention`). Where "model" shards the rows too (`SSM_RULES`),
every rank holds whole sequences of its own rows and no block splits
anything over "model" (`Layout.free`).

Training (weights gathered over their FSDP axes inside the block's
checkpoint region, so the backward reduce-scatters their gradients):
    rglru   channel parallel: this rank's "ffn" channels of w_in,
            w_gate, the conv and the gate vectors; the gates, conv1d and
            scan act channel by channel, and w_out's rows give partial
            sums over "model" in float32, reduce-scattered back to the
            sequence shards and rounded once, as one process's product
            is (the MLP sums its bf16 parts; these stacks carry a
            rounding far: xlstm_350m's embedding gradient ~2000-fold,
            tools/xlstm_bf16_grads.py)
    mlstm   head parallel where the heads split evenly: this rank's
            "heads" columns of wq, wk, wv, its heads' gate columns of
            w_if, wo's rows -> float32 partial sums, as rglru
    slstm   whole on every rank of a row block: its recurrence couples
            every channel at every token (h @ r_gates), so a channel
            split would need a collective a token; each rank runs the
            whole recurrence of its rows on the gathered sequence and
            keeps its positions (the backward sums each rank's share)

Serving (whole weights on every rank, `serving.engine.gathered_weights`;
each state leaf this rank's shard of `launch.specs.cache_shardings`,
tagged on the state as ``spec``):
    prefill every kind runs whole over the gathered prompt of its rows,
            and each leaf of the final state keeps this rank's shard
    decode  rglru: h and the conv tail gathered over their channel axes,
            the one-process step, the shards kept; mlstm: C, n and C_s
            hold key dims of each head (C's third dim), so the readout
            C^T q and the normaliser n . q are partial sums, all-reduced
            in one call before the division (the per-channel int8 scale of
            ``state_quant`` stays local); slstm: the previous h gathered
            for h @ r_gates, m whole, the cell on this rank's channels of
            c, n and h, the new h gathered for ``wo``; a leaf whose rows
            the specs replicate (sLSTM n) gathers its rows after.
"""
from __future__ import annotations

import torch

from repro_torch.models import rglru, xlstm
from repro_torch.parallel.shard import gather_param, refit, shard_slices

# -- training -------------------------------------------------------------------


def train(kind: str, p, x, cfg, lay, sp):
    """x this rank's part of ``lay`` (B_l, S_l, d) -> the block's mixer
    output in the same layout; ``sp`` the specs of p's leaves."""
    mesh = lay.mesh
    if kind == "rglru":
        tp = lay.free(sp["lam"][0])
        w = {k: gather_param(v, sp[k], mesh, keep=tp) for k, v in p.items()}
        out, _ = rglru.apply_seq(w, lay.whole_seq(x), cfg,
                                 f32_out=bool(tp))
        return lay.to_layout(out, tp).to(x.dtype)
    if kind == "mlstm":
        tp = lay.free(sp["wq"][1])
        if tp and cfg.n_heads % mesh.index(tp)[1]:
            tp = ()                       # the columns cut a head
        w = {k: gather_param(v, sp[k], mesh, keep=tp) for k, v in p.items()}
        if tp:
            i, n = mesh.index(tp)
            nh, hl = cfg.n_heads, cfg.n_heads // n
            cols = torch.cat([torch.arange(i * hl, (i + 1) * hl),
                              torch.arange(nh + i * hl, nh + (i + 1) * hl)])
            cols = cols.to(w["w_if"].device)
            w["w_if"], w["b_if"] = w["w_if"][:, cols], w["b_if"][cols]
        out, _ = xlstm.mlstm_seq(w, lay.whole_seq(x), cfg, f32_out=bool(tp))
        return lay.to_layout(out, tp).to(x.dtype)
    if kind == "slstm":
        w = {k: gather_param(v, sp[k], mesh) for k, v in p.items()}
        out, _ = xlstm.slstm_seq(w, lay.whole_seq(x), cfg)
        return lay.to_layout(out, ())
    raise ValueError(kind)


# -- serving --------------------------------------------------------------------

def _rows(lay, ndim: int) -> tuple:
    """The spec of a value this rank computes: its rows, the rest whole."""
    return (lay.batch,) + ((),) * (ndim - 1)


def _keep(state, new, lay):
    """Each leaf of ``new`` (this rank's rows, every channel) -> this
    rank's shard of it, copied into ``state``."""
    for f, spec in state.spec.items():
        v = getattr(new, f)
        getattr(state, f).copy_(refit(v, _rows(lay, v.dim()), spec,
                                      lay.mesh))


def _whole(state, lay, fields) -> dict:
    """``fields`` of ``state`` for this rank's rows, every channel."""
    return {f: refit(getattr(state, f), state.spec[f],
                     _rows(lay, getattr(state, f).dim()), lay.mesh)
            for f in fields}


def prefill(kind: str, p, x, cfg, lay, state):
    """Whole weights ``p``, x this rank's rows and positions (B_l, S_l,
    d) -> the mixer output there; ``state`` takes the final state's
    shards."""
    xs = lay.mesh.all_gather(x, lay.seq, 1) if lay.seq else x
    if kind == "rglru":
        out, new = rglru.apply_seq(p, xs, cfg)
    elif kind == "mlstm":
        out, new = xlstm.mlstm_seq(p, xs, cfg)
    else:
        out, new = xlstm.slstm_seq(p, xs, cfg)
    _keep(state, new, lay)
    return out[:, lay.positions()] if lay.seq else out


def decode(kind: str, p, x, cfg, lay, state, state_quant: bool = False):
    """One token a row (B_l, 1, d) over ``state``'s shards (updated in
    place) -> the mixer output."""
    mesh = lay.mesh
    if kind == "rglru":
        whole = rglru.RGLRUState(**_whole(state, lay, ("h", "conv")))
        out, new = rglru.apply_step(p, x, cfg, whole, state_quant)
        _keep(state, new, lay)
        return out
    sp = state.spec
    if kind == "mlstm":
        keys = sp["C"][2]
        mine = lambda f, *ax: refit(getattr(state, f), sp[f],
                                    (lay.batch, (), *ax), mesh)
        st = xlstm.MLSTMState(C=mine("C", keys, ()), n=mine("n", keys),
                              m=mine("m"), C_s=mine("C_s", keys))
        part = None
        if keys and mesh.index(keys)[1] > 1:
            dh = cfg.d_model // cfg.n_heads
            cut = shard_slices((keys,), (dh,), mesh)[0]

            def reduce(hnum, nq):
                both = mesh.all_reduce(torch.cat([hnum, nq[..., None]], -1),
                                       keys)
                return both[..., :-1], both[..., -1]
            part = (cut, reduce)
        out, new = xlstm.mlstm_step(p, x, cfg, st, state_quant, part=part)
        have = {"C": (lay.batch, (), keys, ()), "n": (lay.batch, (), keys),
                "m": (lay.batch, ()), "C_s": (lay.batch, (), keys)}
    else:
        ch = sp["c"][1]
        cut = shard_slices((ch,), (cfg.d_model,), mesh)[0] if ch else \
            slice(None)
        mine = lambda f: refit(getattr(state, f), sp[f], (lay.batch, ch),
                               mesh)
        h_prev = refit(state.h, sp["h"], (lay.batch, ()), mesh)
        st = xlstm.SLSTMState(c=mine("c"), n=mine("n"), h=None,
                              m=refit(state.m, sp["m"], (lay.batch, ()),
                                      mesh))
        new = xlstm._slstm_cell(p, (x[:, 0] @ p["w_gates"]).float(), st,
                                x.dtype, h_prev=h_prev, ch=cut)
        h = refit(new.h, (lay.batch, ch), (lay.batch, ()), mesh)
        out = h[:, None].to(x.dtype) @ p["wo"]
        have = {"c": (lay.batch, ch), "n": (lay.batch, ch),
                "h": (lay.batch, ch), "m": (lay.batch, ())}
    for f, spec in sp.items():
        getattr(state, f).copy_(refit(getattr(new, f), have[f], spec, mesh))
    return out
