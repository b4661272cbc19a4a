"""The recurrent blocks (RG-LRU, mLSTM, sLSTM) under a mesh of ranks:
the layouts they train and serve in (the reference leaves them to GSPMD
under its mesh; ``repro.models.rglru`` constrains u to ("batch", "seq",
"ffn")).

In training, between blocks the activations are (rows over "batch",
positions over "seq_shard") (`parallel.shard.Layout`); a recurrence
needs every position of its rows, so each block gathers the sequence
over "seq_shard" first and returns its output to the layout after: a
hybrid stack (recurrentgemma_9b) changes layout at every change of
kind, its local attention running context parallel in between
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

Serving (tensor parallel: a rank holds only its shards of the weights,
`launch.specs.serve_param_specs`, passed in as ``sp``; each state leaf
this rank's shard of `launch.specs.cache_shardings`, tagged on the state
as ``spec``; x this rank's rows, the whole sequence, the same on every
rank of "model"; every output element one whole dot product, as one
process computes it: hidden activations and output columns gathered,
never partial products summed):
    rglru   channel parallel: w_in, w_gate, the conv and the gate vectors
            hold the rank's channels, the same slices the state's h and
            conv tail hold, so the gates, the conv1d and the scan (a
            prompt) or the step (decode) run on the rank's own state and
            no state moves; the hidden y is gathered over the channels
            and times the rank's output columns of w_out, gathered (not
            training's float32 partials of w_out's rows: their sum
            rounds otherwise than one process's product); state_quant's
            per-row scale takes a MAX over the channels' ranks
    mlstm   head parallel in the weights, key-dim parallel in the state
            (C, n and C_s hold the key dims of every head: C's third
            dim). A prompt runs `xlstm.mlstm_hidden_seq` on the rank's
            heads (w_if / b_if whole, the heads' i and f columns sliced
            locally, `_head_gates`) and refits its final state from
            heads to key dims in one all-gather. A decode step projects
            q, k, v on the rank's heads and gathers them (one call), the gates on the
            whole w_if; the readout C^T q and the normaliser n . q are
            partial sums over the key dims, all-reduced in one call
            before the division (``state_quant``'s per-channel int8 scale
            stays local). Either way the hidden, whole, times the rank's
            output columns of wo, gathered
    slstm   whole weights on every rank, by layout (nothing gathers
            them; `launch.specs.serve_param_specs`): a prompt runs the
            whole recurrence of the rank's rows and keeps its shards of
            the final state; a decode step gathers the previous h for
            h @ r_gates, m whole, runs the cell on this rank's channels
            of c, n and h and gathers the new h for ``wo``; a leaf whose
            rows the specs replicate (sLSTM n) gathers its rows after
Where the rules give "model" to the rows (`SSM_RULES`) nothing is cut:
each rank runs its rows whole.
"""
from __future__ import annotations

import torch

from repro_torch.models import rglru, xlstm
from repro_torch.parallel.shard import (gather_cols, gather_param, refit,
                                        shard_slices)

# -- training -------------------------------------------------------------------


def train(kind: str, p, x, cfg, lay, sp):
    """x this rank's part of ``lay`` (B_l, S_l, d) -> the block's mixer
    output in the same layout; ``sp`` the specs of p's leaves."""
    mesh = lay.mesh
    if kind == "rglru":
        tp = lay.free(sp["lam"][0])
        w = {k: gather_param(v, sp[k], mesh, keep=tp) for k, v in p.items()}
        y, _ = rglru.hidden_seq(w, lay.whole_seq(x), cfg)
        return lay.to_layout(_rows_out(y, w["w_out"], tp), tp).to(x.dtype)
    if kind == "mlstm":
        tp = lay.free(sp["wq"][1])
        if tp and cfg.n_heads % mesh.index(tp)[1]:
            tp = ()                       # the columns cut a head
        w = {k: gather_param(v, sp[k], mesh, keep=tp) for k, v in p.items()}
        h, _ = xlstm.mlstm_hidden_seq(_head_gates(w, tp, cfg, mesh),
                                      lay.whole_seq(x), cfg)
        return lay.to_layout(_rows_out(h, w["wo"], tp), tp).to(x.dtype)
    if kind == "slstm":
        w = {k: gather_param(v, sp[k], mesh) for k, v in p.items()}
        out, _ = xlstm.slstm_seq(w, lay.whole_seq(x), cfg)
        return lay.to_layout(out, ())
    raise ValueError(kind)


def _rows_out(y, w, tp):
    """A hidden y times the output projection ``w``: over a cut of its
    rows (``tp``) the float32 partial sums, rounded once after
    `Layout.to_layout` sums them; whole, the plain product."""
    return y.float() @ w.float() if tp else y @ w


def _head_gates(p, hx, cfg, mesh) -> dict:
    """The mLSTM's weights ``p`` with ``w_if`` / ``b_if`` (whole on every
    rank) sliced to the i and f columns of this rank's heads (over
    ``hx``; a head's are h and nh + h, not one block)."""
    if not hx or mesh.index(hx)[1] == 1:
        return p
    i, n = mesh.index(hx)
    nh, hl = cfg.n_heads, cfg.n_heads // n
    cols = torch.cat([torch.arange(i * hl, (i + 1) * hl),
                      torch.arange(nh + i * hl, nh + (i + 1) * hl)])
    cols = cols.to(p["w_if"].device)
    return {**p, "w_if": p["w_if"][:, cols], "b_if": p["b_if"][cols]}


# -- serving --------------------------------------------------------------------

def _rows(lay, ndim: int) -> tuple:
    """The spec of a value this rank computes: its rows, the rest whole."""
    return (lay.batch,) + ((),) * (ndim - 1)


def _keep(state, new, lay, have: dict | None = None):
    """Each leaf of ``new`` (this rank's rows; laid out by ``have``, by
    default every channel) -> this rank's shard of it, copied into
    ``state``."""
    for f, spec in state.spec.items():
        v = getattr(new, f)
        h = _rows(lay, v.dim()) if have is None else have[f]
        getattr(state, f).copy_(refit(v, h, spec, lay.mesh))


def _out_cols(w, y, ch, oa, mesh):
    """y (B, S, w_l) this rank's channels (over ``ch``) of a hidden ->
    gathered whole, times this rank's output columns ``w`` (over ``oa``),
    gathered: (B, S, d), each element one whole dot product."""
    return gather_cols(gather_cols(y, ch, mesh) @ w, oa, mesh)


def _rglru_layout(sp, lay) -> dict:
    """The RG-LRU state's layout as the rank's weights compute it: its
    rows and the weights' channels."""
    ch = sp["w_in"][-1]
    return {"h": (lay.batch, ch), "conv": (lay.batch, (), ch)}


def _heads_to_keys(state, new, hx, lay):
    """An mLSTM prompt's final state over this rank's heads (``hx``) ->
    the state's layout (every head, the key dims of ``state.spec``): the
    four leaves gathered over the heads in one all-gather, then cut."""
    mesh, sp = lay.mesh, state.spec
    fields = ("C", "n", "m", "C_s")
    if hx and mesh.index(hx)[1] > 1:
        vals = [getattr(new, f).float() for f in fields]
        B, h = vals[0].shape[:2]
        flat = torch.cat([v.reshape(B, h, -1) for v in vals], -1)
        g = mesh.all_gather(flat, hx, 1)
        sizes = [v[0, 0].numel() for v in vals]
        parts = torch.split(g, sizes, -1)
        new = type(new)(**{f: x.reshape(B, g.shape[1], *v.shape[2:]).to(
            getattr(new, f).dtype) for f, x, v in zip(fields, parts, vals)})
    _keep(state, new, lay)


def prefill(kind: str, p, sp, x, cfg, lay, state):
    """This rank's shards ``p`` (``sp`` their specs), x this rank's rows
    (B_l, S, d) -> the mixer output there; ``state`` takes the final
    state's shards."""
    mesh = lay.mesh
    if kind == "rglru":
        y, new = rglru.hidden_seq(p, x, cfg)
        _keep(state, new, lay, _rglru_layout(sp, lay))
        return _out_cols(p["w_out"], y, sp["w_in"][-1], sp["w_out"][-1],
                         mesh)
    if kind == "mlstm":
        hx = sp["wq"][-1]
        h, new = xlstm.mlstm_hidden_seq(_head_gates(p, hx, cfg, mesh), x,
                                        cfg)
        _heads_to_keys(state, new, hx, lay)
        return _out_cols(p["wo"], h, hx, sp["wo"][-1], mesh)
    out, new = xlstm.slstm_seq(p, x, cfg)
    _keep(state, new, lay)
    return out


def decode(kind: str, p, sp, x, cfg, lay, state, state_quant: bool = False):
    """One token a row (B_l, 1, d) over ``state``'s shards (updated in
    place), this rank's weight shards ``p`` (``sp`` their specs) -> the
    mixer output."""
    mesh = lay.mesh
    if kind == "rglru":
        have = _rglru_layout(sp, lay)
        ch = sp["w_in"][-1]
        st = rglru.RGLRUState(**{f: refit(getattr(state, f), state.spec[f],
                                          have[f], mesh)
                                 for f in ("h", "conv")})
        row_max = None
        if ch and mesh.index(ch)[1] > 1:
            row_max = lambda a: mesh.all_reduce(a, ch, "max")
        y, new = rglru.hidden_step(p, x, cfg, st, state_quant,
                                   row_max=row_max)
        _keep(state, new, lay, have)
        return _out_cols(p["w_out"], y, ch, sp["w_out"][-1], mesh)
    st_sp = state.spec
    if kind == "mlstm":
        keys, hx = st_sp["C"][2], sp["wq"][-1]
        mine = lambda f, *ax: refit(getattr(state, f), st_sp[f],
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
        qkv = gather_cols(torch.stack([x @ p[w] for w in ("wq", "wk", "wv")]),
                          hx, mesh)
        h, new = xlstm.mlstm_hidden_step(p, x, cfg, st, state_quant,
                                         part=part, qkv=tuple(qkv))
        out = gather_cols(h @ p["wo"], sp["wo"][-1], mesh)
        have = {"C": (lay.batch, (), keys, ()), "n": (lay.batch, (), keys),
                "m": (lay.batch, ()), "C_s": (lay.batch, (), keys)}
    else:
        ch = st_sp["c"][1]
        cut = shard_slices((ch,), (cfg.d_model,), mesh)[0] if ch else \
            slice(None)
        mine = lambda f: refit(getattr(state, f), st_sp[f], (lay.batch, ch),
                               mesh)
        h_prev = refit(state.h, st_sp["h"], (lay.batch, ()), mesh)
        st = xlstm.SLSTMState(c=mine("c"), n=mine("n"), h=None,
                              m=refit(state.m, st_sp["m"], (lay.batch, ()),
                                      mesh))
        new = xlstm._slstm_cell(p, (x[:, 0] @ p["w_gates"]).float(), st,
                                x.dtype, h_prev=h_prev, ch=cut)
        h = refit(new.h, (lay.batch, ch), (lay.batch, ()), mesh)
        out = h[:, None].to(x.dtype) @ p["wo"]
        have = {"c": (lay.batch, ch), "n": (lay.batch, ch),
                "h": (lay.batch, ch), "m": (lay.batch, ())}
    _keep(state, new, lay, have)
    return out
