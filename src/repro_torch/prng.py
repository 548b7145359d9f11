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
  * ``uniform``          = ``bitcast((bits >> 9) | 0x3F800000) - 1``
  * ``bernoulli(k, p)``  = ``uniform < float32(p)``

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


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """float32 U[0, 1) of ``shape`` from the 23 high bits of each word."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """bool Bernoulli(p) of ``shape``: ``uniform < float32(p)``."""
    p32 = torch.tensor(p, dtype=torch.float32, device=key.device)
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
