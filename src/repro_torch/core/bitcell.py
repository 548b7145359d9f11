"""Behavioral model of 6T-SRAM bitcell stochasticity under "pseudo-read".

The PyTorch counterpart of ``repro.core.bitcell``.  The paper (§3.1,
Fig. 4) lowers the bitcell supply CVDD while holding both bitlines high,
so thermal noise flips the stored bit with a controllable probability
(the bit flip rate, BFR).  The curves are monotone piecewise-linear
interpolations through digitized anchors from the paper's figures,
evaluated in float32 with the same arithmetic as ``jnp.interp``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.msxor import pack_bits_to_uint

# (CVDD [V], BFR) at nominal 25 C, pseudo-read conditions (Fig. 4(c)).
_BFR_VS_CVDD = np.array(
    [
        (0.30, 0.499),
        (0.40, 0.490),
        (0.45, 0.475),
        (0.50, 0.450),
        (0.55, 0.425),
        (0.60, 0.400),
        (0.65, 0.300),
        (0.70, 0.150),
        (0.75, 0.030),
        (0.80, 0.001),
    ]
)

# (temperature [C], BFR) at CVDD = 0.5 V (Fig. 15).
_BFR_VS_TEMP = np.array(
    [
        (-40.0, 0.360),
        (-20.0, 0.420),
        (0.0, 0.440),
        (25.0, 0.450),
        (70.0, 0.455),
        (85.0, 0.460),
    ]
)

NOMINAL_CVDD = 0.8  # V, standard bitcell supply
PSEUDO_READ_CVDD = 0.5  # V, the paper's operating point
NOMINAL_TEMP_C = 25.0


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32))


def interp(x, xp, fp, left=None, right=None) -> torch.Tensor:
    """Piecewise-linear interpolation in float32, as ``jnp.interp``
    computes it: ``fp[i-1] + ((x - xp[i-1]) / dx) * df`` on the segment
    that ``searchsorted(side='right')`` picks, then ``left``/``right``
    outside ``[xp[0], xp[-1]]``.

    XLA on the CPU contracts the final multiply-add into one fused
    multiply-add.  The product of two float32 values is exact in float64,
    so the sum is formed there and rounded to float32 once."""
    x, xp, fp = _f32(x), _f32(xp), _f32(fp)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    q = delta / torch.where(dx0, 1.0, dx)
    fma = (fp[i - 1].double() + q.double() * df.double()).float()
    f = torch.where(dx0, fp[i - 1], fma)
    lo = fp[0] if left is None else _f32(left)
    hi = fp[-1] if right is None else _f32(right)
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)


def bfr_vs_cvdd(cvdd) -> torch.Tensor:
    """Bit flip rate of a pseudo-read at supply ``cvdd`` volts (25 C)."""
    return interp(
        cvdd, _BFR_VS_CVDD[:, 0], _BFR_VS_CVDD[:, 1], left=0.5, right=0.0
    )


def temperature_factor(temp_c) -> torch.Tensor:
    """Multiplicative thermal factor, normalised to 1.0 at 25 C."""
    base = interp(NOMINAL_TEMP_C, _BFR_VS_TEMP[:, 0], _BFR_VS_TEMP[:, 1])
    cur = interp(
        temp_c,
        _BFR_VS_TEMP[:, 0],
        _BFR_VS_TEMP[:, 1],
        left=float(_BFR_VS_TEMP[0, 1]),
        right=float(_BFR_VS_TEMP[-1, 1]),
    )
    return cur / base


def bit_flip_rate(cvdd=PSEUDO_READ_CVDD, temp_c=NOMINAL_TEMP_C) -> torch.Tensor:
    """p_BFR(CVDD, T) — clipped to the physically meaningful [0, 0.5]."""
    p = bfr_vs_cvdd(cvdd) * temperature_factor(temp_c)
    return torch.clamp(p, 0.0, 0.5)


@dataclasses.dataclass(frozen=True)
class BitcellConfig:
    """Operating condition of the bitcell sub-array during pseudo-read."""

    cvdd: float = PSEUDO_READ_CVDD
    temp_c: float = NOMINAL_TEMP_C

    @property
    def p_bfr(self) -> float:
        return float(bit_flip_rate(self.cvdd, self.temp_c))


def pseudo_read_flip(key: torch.Tensor, stored_bits, p_bfr: float, *, shape=None):
    """Block-wise RNG pseudo-read: every selected bit flips w.p. ``p_bfr``.

    This is the proposal generator (paper §3.2): applied to the bitcells
    that hold the current sample x^(i), it yields the candidate x*, the
    stored bits XOR i.i.d. Bernoulli(p_bfr) flips, as uint8.  ``shape`` is
    accepted for the JAX signature and unused."""
    del shape
    stored_bits = torch.as_tensor(stored_bits, device=key.device)
    flips = prng.bernoulli(key, p_bfr, tuple(stored_bits.shape))
    return stored_bits.to(torch.uint8) ^ flips.to(torch.uint8)


def pseudo_read_fresh(key: torch.Tensor, p_bfr: float, *, shape) -> torch.Tensor:
    """Reset-then-pseudo-read (paper §4.2 step 1+2): bits ~ Bernoulli(p_bfr)
    as uint8, with the key's leading axes first."""
    return prng.bernoulli(key, p_bfr, shape).to(torch.uint8)


def raw_random_words(key: torch.Tensor, p_bfr: float, shape, nbits: int = 32):
    """Biased random *words*: each of ``nbits`` bit-planes ~ Bernoulli(p_bfr),
    packed into uint32 words (int64 tensor)."""
    if not (0 < nbits <= 32):
        raise ValueError(f"nbits must be in (0, 32], got {nbits}")
    bits = prng.bernoulli(key, p_bfr, (*shape, nbits))
    return pack_bits_to_uint(bits, nbits)
