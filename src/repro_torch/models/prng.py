"""JAX's threefry2x32 PRNG as the reference draws with it, in torch integer
ops (``jax.random`` with ``jax_threefry_partitionable`` on, the default of
jax 0.9).

A key is two 32-bit words. Tensors hold each word as a nonnegative int64
masked to 32 bits: torch's ``>>`` on int32 is arithmetic and ``uint32`` has
few ops, so every add is taken modulo 2**32 by hand and every shift sees
a nonnegative value. Keys are (..., 2) int64 tensors.

- `PRNGKey(seed)`: ``[0, seed mod 2**32]`` (the reference runs without
  64-bit mode, so the high word is 0); a seed the reference rejects is
  rejected with the same error type.
- `fold_in(key, data)`: threefry2x32 of the counter pair ``(0, data)``.
- `random_bits(key, n)`: 32-bit words, element j hashing the counter pair
  ``(0, j)`` (the partitionable layout: the high and low words of a 64-bit
  iota) and returning the XOR of the two output words.
- `uniform`, `gumbel` (mode "low") and `categorical` (argmax of gumbel +
  logits, first index on ties) as ``jax.random`` builds them on those bits.

Keys, bits and uniforms equal the reference's bit for bit. Gumbel noise
goes through two float32 logs, and XLA's CPU ``log`` is not torch's: the
two agree within about 1e-6, not bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)

# known answers of jax 0.9.0 (``jax.random``): PRNGKey(7), fold_in of it
# with 3, and 4 bits of that key
KNOWN_KEY_7 = (0, 7)
KNOWN_FOLD_7_3 = (276534068, 1641862660)
KNOWN_BITS_7_3 = (993572756, 1359526531, 3400050533, 2296557208)


def PRNGKey(seed, *, device="cpu") -> torch.Tensor:
    """The reference's legacy key of an integer seed: (2,) int64
    ``[0, seed mod 2**32]``. Python ints outside [-2**63, 2**63) raise
    OverflowError, non-integers TypeError and None ValueError, as
    ``jax.random.PRNGKey`` does."""
    if seed is None:
        raise ValueError("None is not a valid value for a PRNG seed")
    if isinstance(seed, np.ndarray) and seed.ndim:
        raise TypeError(f"PRNGKey accepts a scalar seed, but was given an "
                        f"array of shape {seed.shape} != ()")
    if isinstance(seed, np.ndarray):
        seed = seed[()]
    if not isinstance(seed, (int, np.integer, np.bool_)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    if isinstance(seed, int) and not -2**63 <= seed < 2**63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcastable
    int64 tensors of 32-bit words: key words (k1, k2), counter words
    (x1, x2). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold 32-bit ``data`` into keys: key (..., 2), data broadcastable to
    key[..., 0] (negative values wrap, as a cast to uint32 does) ->
    (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each key: key (..., 2) ->
    (..., n) int64 words in [0, 2**32)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return o1 ^ o2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled, and
    never below ``minval``. key (..., 2) -> (..., n) float32."""
    bits = random_bits(key, n)
    one = 0x3F800000                      # float32(1.0)'s bits
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # the bounds as float32 host scalars (a tensor made here would be a
    # host-to-device copy, a sync, inside the decode step)
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * scale + lo, lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in mode "low": -log(-log(u)), u
    uniform in [tiny, 1). key (..., 2) -> (..., n) float32."""
    u = uniform(key, n, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` per row: the argmax of
    gumbel noise plus the logits, first index on ties. key (B, 2), logits
    (B, V) float32 -> (B,) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
