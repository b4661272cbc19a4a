"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro.models.rglru``).

Block = (gate branch: GeLU(W_gate x)) * (recurrence branch: causal
temporal conv1d -> RG-LRU) -> W_out, with the reference's diagonal
(per-channel) gates:

    r_t = sigmoid(w_a * u_t + b_a)          recurrence gate
    i_t = sigmoid(w_x * u_t + b_x)          input gate
    a_t = exp(-8 * softplus(lam) * r_t)     decay in (0, 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

GeLU is the tanh approximation (``jax.nn.gelu``'s default). A prompt runs
the linear recurrence as the reference's ``jax.lax.associative_scan``
does, level by level in log2(S) steps (`_scan`, the same combine order,
so the same float32 sums); decode is one step. ``state_quant=True``
round-trips the carried h through INT8 with one scale per row before the
step, as the reference does.

The functions are functional, as the reference's: they return a new
`RGLRUState`; the serving path copies it into the persistent state
(`RGLRUState.copy_`), so a decode step keeps every tensor's address.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init

_C = 8.0


def init(cfg, gen: torch.Generator, device) -> dict:
    """The reference's parameters and distributions: projections and conv
    in the activation dtype, the gate vectors float32 (lam = 2, w_a = w_x
    = 0.5, b_a = b_x = 0)."""
    d, w, dt = cfg.d_model, cfg.rnn_width, cfg.activation_dtype
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, d, w, dt, device),
        "w_gate": dense_init(gen, d, w, dt, device),
        "w_out": dense_init(gen, w, d, dt, device),
        "conv_w": (torch.randn((cfg.conv1d_width, w), generator=gen, **f32)
                   * 0.02).to(dt),
        "lam": torch.full((w,), 2.0, **f32),
        "w_a": torch.full((w,), 0.5, **f32),
        "b_a": torch.zeros((w,), **f32),
        "w_x": torch.full((w,), 0.5, **f32),
        "b_x": torch.zeros((w,), **f32),
    }


@dataclasses.dataclass
class RGLRUState:
    """Decode-time carry: h (B, w) float32 and the conv tail (B, cw - 1,
    w) float32."""
    h: torch.Tensor
    conv: torch.Tensor

    def copy_(self, other: "RGLRUState") -> "RGLRUState":
        self.h.copy_(other.h)
        self.conv.copy_(other.conv)
        return self


def init_state(cfg, batch: int, device) -> RGLRUState:
    w = cfg.rnn_width
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return RGLRUState(h=z(batch, w), conv=z(batch, cfg.conv1d_width - 1, w))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gates(p, u):
    """u (..., w) float32 -> (a, b) of the linear recurrence
    h = a * h_prev + b."""
    r = torch.sigmoid(u * p["w_a"] + p["b_a"])
    i = torch.sigmoid(u * p["w_x"] + p["b_x"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u)
    return a, b


def _conv1d(p, u, prev_tail=None):
    """Causal temporal conv over u (B, S, w); ``prev_tail`` (B, cw - 1, w)
    continues a previous call. Returns (out (B, S, w), new tail)."""
    cw = p["conv_w"].shape[0]
    if prev_tail is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = prev_tail.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                       # (B, S+cw-1, w)
    S = u.shape[1]
    out = up[:, 0:S] * p["conv_w"][0]
    for i in range(1, cw):
        out = out + up[:, i:i + S] * p["conv_w"][i]
    return out, up[:, -(cw - 1):]


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a, b):
    """Inclusive scan of `_combine` over axis 1: the recursion of
    ``jax.lax.associative_scan`` (pairs combined, the odd prefixes
    scanned, the even ones filled in), log2(S) levels deep."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (len(even) - len(odd) is
    0 or 1)."""
    B, ne = even.shape[:2]
    no = odd.shape[1]
    out = even.new_empty((B, ne + no, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b, h0=None):
    """Linear scan h_t = a_t h_{t-1} + b_t over axis 1 (time)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    return _assoc_scan(a, b)[1]


def hidden_seq(p, x, cfg, state: RGLRUState | None = None):
    """Prefill up to ``w_out``: x (B, S, d) -> (the hidden y (B, S, w),
    final RGLRUState); over a cut of the channels (a rank's,
    `models.recurrent_mesh`) y and the state are theirs."""
    gate = gelu(x @ p["w_gate"])
    u = (x @ p["w_in"]).float()
    u, tail = _conv1d(p, u, None if state is None else state.conv)
    a, b = _gates(p, u)
    h = _scan(a, b, None if state is None else state.h)      # (B, S, w)
    return h.to(x.dtype) * gate, RGLRUState(h=h[:, -1], conv=tail.float())


def apply_seq(p, x, cfg, state: RGLRUState | None = None):
    """Prefill: x (B, S, d) -> (out (B, S, d), final RGLRUState)."""
    y, state = hidden_seq(p, x, cfg, state)
    return y @ p["w_out"], state


def hidden_step(p, x, cfg, state: RGLRUState, state_quant: bool = False,
                row_max=None):
    """Decode up to ``w_out``: x (B, 1, d) -> (the hidden (B, 1, w), new
    state). ``row_max`` (state_quant over a cut of the channels): the
    rows' absmax over this cut -> theirs over every channel."""
    h_prev = state.h
    if state_quant:
        # symmetric INT8 on the carried state, one scale per batch row
        amax = h_prev.abs().amax(-1, keepdim=True)
        if row_max is not None:
            amax = row_max(amax)
        s = torch.clamp_min(amax, 1e-30) / 127.0
        h_prev = torch.clamp(torch.round(h_prev / s), -127, 127).to(
            torch.int8) * s
    gate = gelu(x @ p["w_gate"])                           # (B, 1, w)
    u = (x @ p["w_in"]).float()
    u, tail = _conv1d(p, u, state.conv)
    a, b = _gates(p, u[:, 0])                              # (B, w)
    h = a * h_prev + b
    return h[:, None].to(x.dtype) * gate, RGLRUState(h=h, conv=tail.float())


def apply_step(p, x, cfg, state: RGLRUState, state_quant: bool = False):
    """Decode: x (B, 1, d) -> (out (B, 1, d), new state)."""
    y, state = hidden_step(p, x, cfg, state, state_quant)
    return y @ p["w_out"], state
