"""The subset of ``jax.random`` that the sampler's streams pass through.

The engine's keys, the ``host`` and ``cim`` operand streams and the
chain keys of every backend are derived with ``jax.random`` in the JAX
package.  This module reproduces those functions bit for bit, without
JAX, for the partitionable Threefry layout (``jax_threefry_partitionable
= True``, the default of current jax):

  * ``PRNGKey(s)``       = ``[0, s mod 2^32]``
  * ``fold_in(k, d)``    = ``threefry2x32(k, (0, d))``
  * ``split(k, n)[i]``   = ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``
  * ``bits(k, shape)``   = ``x0 ^ x1`` of ``threefry2x32(k, (hi, lo))``
    over the row-major 64-bit iota of ``shape``
  * ``uniform``          = ``bitcast((bits >> 9) | 0x3F800000) - 1``,
    then on ``[minval, maxval)`` ``max(minval, u * (maxval - minval) + minval)``
  * ``bernoulli(k, p)``  = ``uniform < float32(p)``
  * ``gumbel``           = ``-log(-log(uniform(tiny, 1)))`` (jax's default
    ``mode="low"``); ``categorical`` = ``argmax(gumbel + logits)``

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
leading axes batch independent keys, and every draw prepends them to its
shape.  Keys are explicit arguments: nothing here holds a global state.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.rng import MASK32, threefry2x32, u32


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax name)
    """The raw key of integer ``seed``: ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def _stack(x0, x1) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold integer ``data`` (an int, or a tensor broadcasting against the
    key's leading axes) into ``key``."""
    if not isinstance(data, int):
        data = torch.as_tensor(data, device=key.device)
    return _stack(*threefry2x32(key[..., 0], key[..., 1], 0, u32(data)))


def _iota_2x32(shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    idx = idx.reshape(shape)
    return idx >> 32, idx & MASK32


def _keyed(key: torch.Tensor, ndim: int):
    """Key words shaped to broadcast against ``ndim`` trailing axes."""
    lead = key.shape[:-1]
    tail = (1,) * ndim
    return key[..., 0].reshape(lead + tail), key[..., 1].reshape(lead + tail)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key``: shape (..., num, 2)."""
    hi, lo = _iota_2x32((num,), key.device)
    k0, k1 = _keyed(key, 1)
    return _stack(*threefry2x32(k0, k1, hi, lo))


def bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Raw uint32 words of ``shape`` (int64 tensor, leading key axes first)."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _iota_2x32(shape, key.device)
    k0, k1 = _keyed(key, len(shape))
    x0, x1 = threefry2x32(k0, k1, hi, lo)
    return x0 ^ x1


def uniform(
    key: torch.Tensor, shape: tuple, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """float32 U[minval, maxval) of ``shape`` from the 23 high bits of each
    word: U[0, 1) scaled and shifted in float32, then held at ``minval``
    or above, as ``jax.random.uniform`` computes it."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:  # u * 1 + 0 and max(0, u) are u
        return floats
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA contracts it into a
    fused multiply-add: the product is exact in float64, the sum is
    rounded to odd there (the neighbour of the nearest sum whose last bit
    is 1 when the sum is inexact), and the one rounding to float32 is then
    the fused one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)  # the exact sum is s + err
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """float32 standard Gumbel draws of ``shape`` (jax's ``mode="low"``)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One category a row of float32 ``logits`` (..., V), by the Gumbel-max
    trick over the last axis; int64 indices, the first on a tie."""
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=-1)


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """bool Bernoulli(p) of ``shape``: ``uniform < float32(p)``."""
    p32 = torch.full((), p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p32


def randint(
    key: torch.Tensor, shape: tuple, minval: int, maxval: int, dtype: str = "int32"
) -> torch.Tensor:
    """Integers in ``[minval, maxval)`` of ``shape`` and ``dtype`` ("int32"
    or "uint32"), as ``jax.random.randint`` draws them: the bounds clipped
    to the dtype's range (a ``maxval`` above it widens the span by one),
    two bit draws from ``split(key)`` folded into the span by a
    multiply-mod in uint32 arithmetic.  Returns an int64 tensor holding
    the values."""
    bounds = {"int32": (-(2**31), 2**31 - 1), "uint32": (0, MASK32)}
    if dtype not in bounds:
        raise ValueError(f"dtype must be 'int32' or 'uint32', got {dtype!r}")
    lo, hi = bounds[dtype]
    out_of_range = int(maxval) > hi
    minval = max(lo, min(int(minval), hi))
    maxval = max(lo, min(int(maxval), hi))
    if maxval <= minval:
        span = 1
    else:  # a span of 2^32 is uint32's 0: the remainders below leave the bits as they are
        span = ((maxval - minval) & MASK32) + int(out_of_range)
    ks = split(key)
    higher, lower = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    multiplier = (((2**16 % span) ** 2) & MASK32) % span
    offset = ((higher % span) * multiplier) & MASK32
    offset = ((offset + lower % span) & MASK32) % span
    return minval + offset
