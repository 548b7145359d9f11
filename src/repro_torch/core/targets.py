"""Target distributions p(x) for the MCMC benchmarks — paper §6.6, Fig. 17.

The PyTorch counterpart of ``repro.core.targets``.  The macro samples
k-bit integer words; continuous targets are evaluated on a uniform grid
over a box, with the word's bit-field split across dimensions.  A
Gray-code option makes single-bit flips move to adjacent grid cells.

Words are uint32 values held in int64 tensors.  The densities keep the
JAX package's float32 operation order, so their log-probs stay within an
ULP or two of it:

  * the quadratic form is the ``einsum``'s contraction as XLA runs it on
    the CPU: a dot product starts with its first product and adds each
    further one by a fused multiply-add (``_dot``);
  * ``logsumexp`` is ``jax.scipy.special.logsumexp``'s order: max, 0
    where the max is not finite, ``exp``, a sum in component order, the
    log of its magnitude, plus the max;
  * the inverse and log-determinant of the constant covariances are
    computed once, in float32 on the CPU, and moved to the device.

What is left is ``exp`` and ``log`` themselves, which differ by an ULP
between XLA's and PyTorch's implementations (the tests state the bound).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

LogProbFn = Callable[[torch.Tensor], torch.Tensor]  # int words (...,) -> log p (...,)

MASK32 = 0xFFFFFFFF


def _words(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK32


def binary_to_gray(x) -> torch.Tensor:
    x = _words(x)
    return x ^ (x >> 1)


def gray_to_binary(g) -> torch.Tensor:
    g = _words(g)
    b = g
    for shift in (1, 2, 4, 8, 16):
        b = b ^ (b >> shift)
    return b


def _f32(value: float, device) -> torch.Tensor:
    """A Python float as JAX's weak type meets a float32 array: rounded
    to float32 once, filled in on ``device`` (no copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class GridCodec:
    """Maps k-bit integer words <-> points in a [lo, hi]^dim box."""

    nbits: int                       # total bits in the word
    dim: int = 1
    lo: tuple = (-8.0,)
    hi: tuple = (8.0,)
    gray: bool = False               # Gray-coded per-dimension fields

    def __post_init__(self):
        if self.nbits % self.dim != 0:
            raise ValueError("nbits must divide evenly across dimensions")
        if len(self.lo) != self.dim or len(self.hi) != self.dim:
            raise ValueError("lo/hi must have length dim")

    @property
    def bits_per_dim(self) -> int:
        return self.nbits // self.dim

    @property
    def levels(self) -> int:
        return 1 << self.bits_per_dim

    def decode(self, words) -> torch.Tensor:
        """(...,) uint words -> (..., dim) float32 coordinates (cell centers)."""
        b = self.bits_per_dim
        mask = (1 << b) - 1
        words = _words(words)
        dev = words.device
        coords = []
        for d in range(self.dim):
            field = (words >> (d * b)) & mask
            if self.gray:
                field = gray_to_binary(field) & mask
            frac = (field.to(torch.float32) + 0.5) / _f32(self.levels, dev)
            coords.append(
                _f32(self.lo[d], dev) + frac * _f32(self.hi[d] - self.lo[d], dev)
            )
        return torch.stack(coords, dim=-1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(..., dim) float -> (...,) uint words (nearest cell), int64."""
        b = self.bits_per_dim
        dev = x.device
        word = torch.zeros(x.shape[:-1], dtype=torch.int64, device=dev)
        for d in range(self.dim):
            frac = (x[..., d] - _f32(self.lo[d], dev)) / _f32(self.hi[d] - self.lo[d], dev)
            cell = torch.floor(frac * _f32(self.levels, dev))
            cell = torch.where(torch.isnan(cell), torch.zeros_like(cell), cell)
            field = torch.clamp(cell, 0, self.levels - 1).to(torch.int64)
            if self.gray:
                field = binary_to_gray(field)
            word = word | (field << (d * b))
        return word


# --- continuous densities -------------------------------------------------


def _dot(pairs) -> torch.Tensor:
    """sum_i a_i * b_i as XLA's CPU dot accumulates it: the first product,
    then a fused multiply-add for each further term.  The float32 product
    is exact in float64, so each fused step is formed there and rounded
    once (a double rounding can differ from a true FMA with probability
    about 2^-29 per step)."""
    (a0, b0), *rest = pairs
    acc = a0 * b0
    for a, b in rest:
        acc = (a.double() * b.double() + acc.double()).float()
    return acc


def _log_norm(dim: int) -> torch.Tensor:
    """``dim * jnp.log(2.0 * jnp.pi)`` in float32."""
    return _f32(dim, "cpu") * torch.log(_f32(2.0 * math.pi, "cpu"))


@functools.lru_cache(maxsize=None)
def _gaussian_consts(means: tuple, covs: tuple, device: str):
    """(means, precisions, log-determinants, dim * log 2pi) in float32,
    computed on the CPU once per device."""
    mu = torch.tensor(means, dtype=torch.float32)
    cov = torch.tensor(covs, dtype=torch.float32)
    prec = torch.linalg.inv(cov)
    logdet = torch.linalg.slogdet(cov)[1]
    c = _log_norm(mu.shape[-1])
    return tuple(t.to(device) for t in (mu, prec, logdet, c))


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.logsumexp(x, axis=-1)`` in its operation order."""
    m = torch.amax(x, dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    t = torch.exp(x - m[..., None])
    s = t[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + t[..., k]
    return torch.log(torch.abs(s)) + m


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Mixture of diagonal/full-covariance Gaussians (paper Fig. 17(a): 4 comps)."""

    means: tuple            # (K, dim)
    covs: tuple             # (K, dim, dim)
    weights: tuple          # (K,)

    @staticmethod
    def paper_gmm() -> "GaussianMixture":
        """A 4-component 1-D mixture matching Fig. 17(a)'s qualitative shape."""
        means = ((-6.0,), (-2.0,), (2.0,), (6.0,))
        covs = (((0.8,),), ((0.5,),), ((0.7,),), ((1.0,),))
        weights = (0.2, 0.3, 0.3, 0.2)
        return GaussianMixture(means, covs, weights)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., dim) float32 -> (...,) log density.

        The quadratic form is ``einsum("...ki,kij,...kj->...k")`` as XLA
        contracts it: the outer product d_a d_b, then one dot over (a, b)
        against the precision."""
        mu, prec, logdet, c = _gaussian_consts(self.means, self.covs, str(x.device))
        logw = _mixture_log_weights(self.weights, str(x.device))
        diff = x[..., None, :] - mu                     # (..., K, dim)
        dim = mu.shape[-1]
        maha = _dot([
            (diff[..., b] * diff[..., a], prec[:, a, b])
            for a in range(dim) for b in range(dim)
        ])                                              # (..., K)
        log_comp = -0.5 * ((maha + logdet) + c) + logw
        return logsumexp(log_comp)


@functools.lru_cache(maxsize=None)
def _mixture_log_weights(weights: tuple, device: str) -> torch.Tensor:
    return torch.log(torch.tensor(weights, dtype=torch.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class MultivariateGaussian:
    """Multivariate normal (paper Fig. 17(b): bivariate example)."""

    mean: tuple
    cov: tuple

    @staticmethod
    def paper_mgd() -> "MultivariateGaussian":
        """Correlated bivariate Gaussian matching Fig. 17(b)'s heat map."""
        return MultivariateGaussian(mean=(0.0, 0.0), cov=((1.0, 0.6), (0.6, 1.2)))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., dim) float32 -> (...,) log density.

        ``einsum("...i,ij,...j->...")`` as XLA contracts it: y_j = sum_i
        P_ij d_i first, then sum_j d_j y_j."""
        mu, prec, logdet, c = _gaussian_consts(self.mean, self.cov, str(x.device))
        diff = x - mu
        dim = mu.shape[-1]
        y = [_dot([(prec[i, j], diff[..., i]) for i in range(dim)]) for j in range(dim)]
        maha = _dot([(diff[..., j], y[j]) for j in range(dim)])
        return -0.5 * ((maha + logdet) + c)


# --- discrete word-space targets ------------------------------------------


def discretized_target(density, codec: GridCodec) -> LogProbFn:
    """log p over k-bit words = log density at the decoded grid point."""

    def log_prob(words: torch.Tensor) -> torch.Tensor:
        return density.log_prob(codec.decode(words))

    return log_prob


def table_target(log_prob_table) -> LogProbFn:
    """Target given as an explicit table over all 2^k words (or V logits).

    As in the JAX package the words are read as int32: a word at or above
    2^31 is negative there, is clipped to index 0 and counts as in range.
    The table is copied to the words' device once, on the first call there."""
    table = torch.as_tensor(log_prob_table, dtype=torch.float32)
    vocab = table.shape[-1]
    on_device = {table.device: table}

    def log_prob(words: torch.Tensor) -> torch.Tensor:
        w = _words(words)
        w = w - ((w >> 31) << 32)  # the int32 value of the uint32 word
        safe = torch.clamp(w, 0, vocab - 1)
        if w.device not in on_device:
            on_device[w.device] = table.to(w.device)
        vals = on_device[w.device][safe]
        return torch.where(w < vocab, vals, torch.full_like(vals, float("-inf")))

    return log_prob


def categorical_from_logits(logits, temperature: float = 1.0) -> LogProbFn:
    """Unnormalised categorical target — softmax-free (only ratios are used).
    Divides by a full float32 tensor, so no backend swaps the division for
    a reciprocal multiply."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    return table_target(logits / torch.full_like(logits, temperature))


def reference_grid_probs(density, codec: GridCodec) -> np.ndarray:
    """Exact normalised cell probabilities on the codec grid (for TV
    tests): the float32 log-densities on the CPU, normalised in float64."""
    words = torch.arange(1 << codec.nbits, dtype=torch.int64)
    logp = density.log_prob(codec.decode(words)).numpy().astype(np.float64)
    p = np.exp(logp - logp.max())
    return p / p.sum()
