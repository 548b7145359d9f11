"""Bit-flip proposal and its transfer matrix — paper §3.2, Fig. 6.

The PyTorch counterpart of ``repro.core.proposal``.  The block-wise
pseudo-read applied to the bitcells holding x^(i) flips every bit
independently with probability p_BFR, so

    q(y | x) = p^d(x,y) * (1-p)^(k - d(x,y)),   d = Hamming distance.

d(x,y) = d(y,x)  =>  q is symmetric  =>  the MH accept ratio collapses to
alpha = p(x*) / p(x^(i))   (no proposal densities, no normaliser).

Words are uint32 values held in int64 tensors; the analytics are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.msxor import pack_bits_to_uint

MASK32 = 0xFFFFFFFF


def propose_bitflip(key: torch.Tensor, state: torch.Tensor, p_bfr, nbits: int):
    """Flip each of the low ``nbits`` bits of integer ``state`` w.p. p_bfr.

    state: (...,) uint32 words.  Returns candidate words, same shape, as
    int64.  Vectorised analogue of pseudo-read over a block of
    compartments; the flips are ``jax.random.bernoulli``'s stream
    (``prng.bernoulli``), bit-plane i of the mask on axis -1.
    """
    state = torch.as_tensor(state, device=key.device).to(torch.int64) & MASK32
    flips = prng.bernoulli(key, float(p_bfr), (*state.shape, nbits))
    return state ^ pack_bits_to_uint(flips, nbits)


def propose_bitflip_from_words(state, flip_words, nbits: int):
    """Same proposal, but from pre-generated biased flip words.

    ``flip_words`` carries Bernoulli(p_bfr) bit-planes (cf.
    bitcell.raw_random_words); only the low ``nbits`` are used.
    """
    mask = (1 << nbits) - 1
    state = torch.as_tensor(state).to(torch.int64) & MASK32
    return state ^ (torch.as_tensor(flip_words).to(torch.int64) & mask)


def hamming_distance(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Popcount of x ^ y (numpy, for analytics/tests)."""
    v = np.bitwise_xor(np.asarray(x, dtype=np.uint64), np.asarray(y, dtype=np.uint64))
    # vectorised popcount
    count = np.zeros_like(v)
    while np.any(v):
        count += v & 1
        v >>= 1
    return count


def transfer_matrix(nbits: int, p_bfr: float) -> np.ndarray:
    """Full 2^k x 2^k transfer matrix q(i, j) (paper Fig. 6).

    Only practical for small k (analytics/tests); q is symmetric and
    doubly-stochastic.
    """
    n = 1 << nbits
    idx = np.arange(n)
    d = hamming_distance(idx[:, None], idx[None, :]).astype(np.float64)
    return (p_bfr**d) * ((1.0 - p_bfr) ** (nbits - d))


def mh_transition_matrix(nbits: int, p_bfr: float, log_prob: np.ndarray) -> np.ndarray:
    """Exact MH transition kernel P for a k-bit target (for stationarity tests).

    P[i, j] = q(i,j) * min(1, p(j)/p(i))  for j != i, diagonal = leftover.
    """
    n = 1 << nbits
    if log_prob.shape != (n,):
        raise ValueError(f"log_prob must have shape ({n},)")
    q = transfer_matrix(nbits, p_bfr)
    ratio = np.exp(np.clip(log_prob[None, :] - log_prob[:, None], -700, 0.0))
    accept = np.minimum(1.0, ratio)
    p_mat = q * accept
    np.fill_diagonal(p_mat, 0.0)
    np.fill_diagonal(p_mat, 1.0 - p_mat.sum(axis=1))
    return p_mat
