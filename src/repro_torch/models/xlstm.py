"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (port of
``repro.models.xlstm``).

mLSTM, the stabilized exponential-gating form:

    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = f'_t C_{t-1} + i'_t k_t v_t^T        f' = exp(log f + m_{t-1} - m_t)
    n_t = f'_t n_{t-1} + i'_t k_t              i' = exp(log i - m_t)
    h_t = C_t^T q_t / max(|n_t^T q_t|, exp(-m_t))

A prompt runs the reference's chunkwise-parallel form (quadratic inside a
chunk of ``chunk`` tokens, recurrent across chunks; S must be a multiple
of the chunk, as there); decode is the O(1) step, optionally with the
matrix memory stored INT8 with per-channel scales between steps
(``state_quant``). sLSTM is a true recurrence: a prompt steps through its
tokens one at a time (a host loop), as the reference's ``jax.lax.scan``.

The head count comes from the weights (``w_if`` has two columns a head),
so a rank of a mesh runs its cut of the heads (`models.recurrent_mesh`);
`mlstm_hidden_step` takes the key-dim part a rank holds of a sharded
matrix memory, and the sLSTM cell the channels a rank holds of its state.

Every contraction is a plain matmul or einsum, as the reference computes
them outside any Pallas kernel. The functions are functional and return
new states; the serving path copies them into the persistent state
(``copy_``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.costing import host_loop
from repro_torch.models.common import dense_init
from repro_torch.models.rglru import softplus


def _copy_fields(dst, src, names):
    for n in names:
        getattr(dst, n).copy_(getattr(src, n))
    return dst


# -- mLSTM --------------------------------------------------------------------

def mlstm_init(cfg, gen: torch.Generator, device) -> dict:
    d, nh, dt = cfg.d_model, cfg.n_heads, cfg.activation_dtype
    return {
        "wq": dense_init(gen, d, d, dt, device),
        "wk": dense_init(gen, d, d, dt, device),
        "wv": dense_init(gen, d, d, dt, device),
        "wo": dense_init(gen, d, d, dt, device),
        "w_if": dense_init(gen, d, 2 * nh, torch.float32, device),
        "b_if": torch.cat([torch.zeros((nh,), device=device),
                           torch.full((nh,), 3.0, device=device)]),
    }


@dataclasses.dataclass
class MLSTMState:
    """C (B, H, dh, dh) float32 (int8 under state_quant), n (B, H, dh),
    m (B, H), C_s (B, H, dh) the per-channel scales of an int8 C."""
    C: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    C_s: torch.Tensor

    def copy_(self, other: "MLSTMState") -> "MLSTMState":
        return _copy_fields(self, other, ("C", "n", "m", "C_s"))


def mlstm_init_state(cfg, batch: int, state_quant: bool = False, *,
                     device) -> MLSTMState:
    nh, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, nh, dh, dh),
                      dtype=torch.int8 if state_quant else torch.float32,
                      device=device),
        n=torch.zeros((batch, nh, dh), **f32),
        m=torch.full((batch, nh), -1e30, **f32),
        C_s=torch.full((batch, nh, dh), 1e-30, **f32))


def _heads(p, cfg) -> tuple[int, int]:
    """(heads of ``p``, head width): the weights may hold a cut of the
    heads."""
    return p["w_if"].shape[1] // 2, cfg.d_model // cfg.n_heads


def _qkv_gates(p, x, cfg, qkv=None):
    """x (B, S, d) -> q, k, v (B, H, S, dh) in x's dtype (k / sqrt(dh)),
    log_i, log_f (B, H, S) float32; H the heads of ``p``. ``qkv``: x's
    projections (x @ wq, x @ wk, x @ wv) where they are computed already
    (a rank's heads, gathered)."""
    B, S, _ = x.shape
    nh, dh = _heads(p, cfg)
    if qkv is None:
        qkv = (x @ p["wq"], x @ p["wk"], x @ p["wv"])
    heads = lambda t: t.reshape(B, S, nh, dh).transpose(1, 2)
    q = heads(qkv[0])
    k = heads(qkv[1]) / torch.sqrt(torch.tensor(float(dh), dtype=x.dtype))
    v = heads(qkv[2])
    gates = x.float() @ p["w_if"] + p["b_if"]                  # (B, S, 2nh)
    log_i = -softplus(-gates[..., :nh])
    log_f = -softplus(-gates[..., nh:])
    return q, k, v, log_i.transpose(1, 2), log_f.transpose(1, 2)


def mlstm_hidden_seq(p, x, cfg, chunk: int = 256):
    """Chunkwise-parallel prefill up to ``wo``: x (B, S, d) -> (the heads'
    hidden (B, S, H * dh), final MLSTMState), quadratic within a chunk
    and recurrent across chunks; H the heads of ``p`` (a rank's cut,
    `models.recurrent_mesh`)."""
    B, S, _ = x.shape
    nh, dh = _heads(p, cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_seq: S={S} is no multiple of the chunk "
                         f"{chunk}")
    nc = S // chunk
    q, k, v, log_i, log_f = _qkv_gates(p, x, cfg)             # (B,H,S,*)
    qc = q.float().reshape(B, nh, nc, chunk, dh)
    kc = k.float().reshape(B, nh, nc, chunk, dh)
    vc = v.float().reshape(B, nh, nc, chunk, dh)
    lic = log_i.reshape(B, nh, nc, chunk)
    lfc = log_f.reshape(B, nh, nc, chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ninf = torch.tensor(-math.inf, device=x.device)

    Cp = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
    np_ = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    mp = torch.full((B, nh), -1e30, dtype=torch.float32, device=x.device)
    hs = []
    chunks = host_loop(nc)
    for c in chunks:
        qt, kt, vt = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        li, lf = lic[:, :, c], lfc[:, :, c]
        L = torch.cumsum(lf, dim=-1)                           # (B,H,c)
        # intra-chunk exponents e_int[t, s] = L_t - L_s + li_s (s <= t)
        e_int = L[..., :, None] - L[..., None, :] + li[..., None, :]
        e_int = torch.where(tri, e_int, ninf)
        # carried-state exponent e_st[t] = L_t + m_prev
        e_st = L + mp[..., None]
        m_t = torch.maximum(e_int.amax(-1), e_st)              # (B,H,c)
        D = torch.exp(e_int - m_t[..., None])                  # (B,H,c,c)
        w_st = torch.exp(e_st - m_t)                           # (B,H,c)
        scores = torch.einsum("bhtd,bhsd->bhts", qt, kt)
        num = (torch.einsum("bhts,bhse->bhte", D * scores, vt) +
               w_st[..., None] * torch.einsum("bhde,bhtd->bhte", Cp, qt))
        nq = (torch.einsum("bhts,bhsd,bhtd->bht", D, kt, qt) +
              w_st * torch.einsum("bhd,bhtd->bht", np_, qt))
        den = torch.clamp_min(torch.maximum(nq.abs(), torch.exp(-m_t)),
                              1e-12)
        hs.append(num / den[..., None])                        # (B,H,c,dh)
        # chunk-end state update, stabilized by the new running max m_n
        Lc = L[..., -1:]                                       # (B,H,1)
        e_upd = Lc - L + li                                    # (B,H,c)
        m_n = torch.maximum(Lc[..., 0] + mp, e_upd.amax(-1))
        wu = torch.exp(e_upd - m_n[..., None])
        decay = torch.exp(Lc[..., 0] + mp - m_n)
        Cp = (decay[..., None, None] * Cp +
              torch.einsum("bhs,bhsd,bhse->bhde", wu, kt, vt))
        np_ = decay[..., None] * np_ + torch.einsum("bhs,bhsd->bhd", wu, kt)
        mp = m_n
    h = torch.stack(chunks.repeat(hs), dim=2).reshape(B, nh, S, dh)
    h = h.transpose(1, 2).reshape(B, S, nh * dh).to(x.dtype)
    state = MLSTMState(C=Cp, n=np_, m=mp,
                       C_s=torch.full(np_.shape, 1e-30, dtype=torch.float32,
                                      device=x.device))
    return h, state


def mlstm_seq(p, x, cfg, chunk: int = 256):
    """Chunkwise-parallel prefill: x (B, S, d) -> ((B, S, d), final
    MLSTMState)."""
    h, state = mlstm_hidden_seq(p, x, cfg, chunk)
    return h @ p["wo"], state


def mlstm_hidden_step(p, x, cfg, state: MLSTMState,
                      state_quant: bool = False, part=None, qkv=None):
    """Decode step up to ``wo``: x (B, 1, d) -> (the heads' hidden (B, 1,
    d), new state). ``part`` (keys, reduce):
    ``state`` holds the key dims ``keys`` (a slice) of C, n and C_s, a
    rank's part of a memory sharded over them; the readout ``C^T q`` and
    the normaliser ``n . q`` are then partial sums over the key dims, and
    ``reduce(hnum, nq)`` returns them summed over every part. ``qkv``:
    x's q, k, v projections computed already (`_qkv_gates`)."""
    B = x.shape[0]
    keys = slice(None) if part is None else part[0]
    q, k, v, log_i, log_f = _qkv_gates(p, x, cfg, qkv)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]                # (B,H,dh)
    log_i, log_f = log_i[..., 0], log_f[..., 0]                 # (B,H)

    C_prev = state.C.float()
    if state_quant:
        # the INT8 matrix memory dequantized (per-channel scale over rows)
        C_prev = C_prev * state.C_s[..., None]

    m_new = torch.maximum(log_f + state.m, log_i)
    f_eff = torch.exp(log_f + state.m - m_new)[..., None]
    i_eff = torch.exp(log_i - m_new)[..., None]
    k = k[..., keys]
    C = f_eff[..., None] * C_prev + (i_eff * k)[..., None] * v[..., None, :]
    n = f_eff * state.n + i_eff * k
    qf = q.float()[..., keys]
    hnum = torch.einsum("bhde,bhd->bhe", C, qf)
    nq = torch.einsum("bhd,bhd->bh", n, qf)
    if part is not None:
        hnum, nq = part[1](hnum, nq)
    hden = torch.maximum(nq.abs()[..., None], torch.exp(-m_new)[..., None])
    h = (hnum / hden).reshape(B, 1, -1).to(x.dtype)

    if state_quant:
        # per-channel INT8 on the matrix memory: channel = last dim
        s = torch.clamp_min(C.abs().amax(-1), 1e-30) / 127.0
        C_q = torch.clamp(torch.round(C / s[..., None]), -127, 127).to(
            torch.int8)
        return h, MLSTMState(C=C_q, n=n, m=m_new, C_s=s)
    return h, MLSTMState(C=C, n=n, m=m_new, C_s=state.C_s)


def mlstm_step(p, x, cfg, state: MLSTMState, state_quant: bool = False):
    """Decode step: x (B, 1, d) -> ((B, 1, d), new state)."""
    h, state = mlstm_hidden_step(p, x, cfg, state, state_quant)
    return h @ p["wo"], state


# -- sLSTM --------------------------------------------------------------------

def slstm_init(cfg, gen: torch.Generator, device) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    return {
        "w_gates": dense_init(gen, d, 4 * d, dt, device),      # i, f, z, o
        "r_gates": dense_init(gen, d, 4 * d, dt, device),      # recurrent
        "wo": dense_init(gen, d, d, dt, device),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
    }


@dataclasses.dataclass
class SLSTMState:
    """c, n, h, m: (B, d) float32."""
    c: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor

    def copy_(self, other: "SLSTMState") -> "SLSTMState":
        return _copy_fields(self, other, ("c", "n", "h", "m"))


def slstm_init_state(cfg, batch: int, *, device) -> SLSTMState:
    z = lambda: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                            device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, cfg.d_model), -1e30,
                                   dtype=torch.float32, device=device))


def _slstm_cell(p, gx, st: SLSTMState, dtype, h_prev=None,
                ch=slice(None)):
    """One step from the input's gate pre-activations ``gx`` (B, 4d)
    float32 (x_t @ w_gates) and the state. Where ``st`` holds the
    channels ``ch`` of c, n and h (a rank's part), ``h_prev`` is the
    whole previous h and the new c, n, h are those channels; m is
    whole."""
    hp = st.h if h_prev is None else h_prev
    g = gx + (hp.to(dtype) @ p["r_gates"]).float() + p["b"]
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    log_i = gi                                    # exponential input gate
    log_f = -softplus(-gf)                        # log sigmoid(f)
    m_new = torch.maximum(log_f + st.m, log_i)
    i_eff = torch.exp(log_i - m_new)[..., ch]
    f_eff = torch.exp(log_f + st.m - m_new)[..., ch]
    go = go[..., ch]
    c = f_eff * st.c + i_eff * torch.tanh(gz[..., ch])
    n = f_eff * st.n + i_eff
    h = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-12)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_seq(p, x, cfg, state: SLSTMState | None = None):
    """Prefill: x (B, S, d) -> ((B, S, d), final state), one token at a
    time (the input projection of every token in one matmul first)."""
    B, S, d = x.shape
    st = state or slstm_init_state(cfg, B, device=x.device)
    gx = (x @ p["w_gates"]).float()                            # (B, S, 4d)
    hs = []
    tokens = host_loop(S)
    for t in tokens:
        st = _slstm_cell(p, gx[:, t], st, x.dtype)
        hs.append(st.h)
    out = torch.stack(tokens.repeat(hs), dim=1).to(x.dtype) @ p["wo"]
    return out, st


def slstm_step(p, x, cfg, state: SLSTMState):
    st = _slstm_cell(p, (x[:, 0] @ p["w_gates"]).float(), state, x.dtype)
    return st.h[:, None].to(x.dtype) @ p["wo"], st
