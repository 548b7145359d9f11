"""Accurate [0,1] RNG module — paper §4.2.

The PyTorch counterpart of ``repro.core.uniform_rng``.  Pipeline (mirrors
the circuit):

  1. reset the RNG sub-array bitcells to "0"            (lambda_0 <= 0.5)
  2. pseudo-read -> raw bits ~ Bernoulli(p_BFR)          (biased)
  3. MSXOR n-stage fold -> debiased bits (lambda_n ~ 0.5)
  4. pack ``bit_width`` debiased bits into an integer R_n
  5. u = R_n / 2^bit_width  in [0, 1)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core import bitcell, msxor


@dataclasses.dataclass(frozen=True)
class UniformRNGConfig:
    p_bfr: float = 0.45          # pseudo-read at CVDD=0.5 V, 25 C
    n_stages: int = 3            # MSXOR stages (paper: 3 for p_BFR >= 0.4)
    bit_width: int = 8           # output sample precision (paper: 8-bit)

    def __post_init__(self):
        if not 0.0 < self.p_bfr <= 0.5:
            raise ValueError(f"p_bfr must be in (0, 0.5], got {self.p_bfr}")
        if not 1 <= self.bit_width <= 32:
            raise ValueError(f"bit_width must be in [1,32], got {self.bit_width}")

    @property
    def debias_error(self) -> float:
        return msxor.debias_error(self.p_bfr, self.n_stages)


def uniform_words(
    key: torch.Tensor, shape, p_bfr: float, bit_width: int = 8, n_stages: int = 3
) -> torch.Tensor:
    """Debiased ``bit_width``-bit integers (int64) of the batch ``shape``."""
    raw = bitcell.pseudo_read_fresh(
        key, p_bfr, shape=(*shape, 1 << n_stages, bit_width)
    )
    bits = msxor.debias_bits(raw, n_stages=n_stages)
    return msxor.pack_bits_to_uint(bits, bit_width)


def uniform(
    key: torch.Tensor, shape, p_bfr: float, bit_width: int = 8, n_stages: int = 3
) -> torch.Tensor:
    """u ~ U[0,1) float32 with per-bit bias |0.5 - lambda| =
    debias_error(p, n).  Dividing by a power of two is exact."""
    words = uniform_words(key, shape, p_bfr, bit_width, n_stages)
    return words.to(torch.float32) / float(1 << bit_width)


class AccurateUniformRNG:
    """Stateful convenience wrapper: each ``draw`` splits its key
    (``key, sub = prng.split(key)``) and draws ``uniform`` from ``sub``,
    so draw n equals the JAX package's draw n bit for bit.  Draws land
    on the key's device."""

    def __init__(self, key, config: UniformRNGConfig = UniformRNGConfig()):
        self._key = torch.as_tensor(key, dtype=torch.int64)
        self.config = config

    def draw(self, shape=()) -> torch.Tensor:
        self._key, sub = prng.split(self._key)
        return uniform(
            sub, tuple(shape), self.config.p_bfr, self.config.bit_width,
            self.config.n_stages,
        )
