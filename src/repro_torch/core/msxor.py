"""Multi-stage XOR (MSXOR) debiasing — paper §4.2 + Appendix A.

The PyTorch counterpart of ``repro.core.msxor``.  A raw pseudo-read bit
is "1" with probability lambda_0 = p_BFR < 0.5; XOR-ing two i.i.d.
biased bits gives lambda_{n+1} = 2 lambda_n (1 - lambda_n), whose fixed
point on (0, 0.5] is 0.5.  The circuit folds *words* pairwise through an
n-stage XOR tree (8 -> 4 -> 2 -> 1 for three stages); this module
reproduces that dataflow on int64 tensors of uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_STAGES = 3  # paper: 3 stages adequate for p_BFR >= 0.4


def lambda_recursion(p_bfr: float, n_stages: int) -> float:
    """lambda_n after ``n_stages`` XOR stages (paper Fig. 9(d) analytics)."""
    lam = float(p_bfr)
    for _ in range(n_stages):
        lam = 2.0 * lam * (1.0 - lam)
    return lam


def debias_error(p_bfr: float, n_stages: int) -> float:
    """Distance from the uniform point, 0.5 - lambda_n (paper Fig. 9(d))."""
    return 0.5 - lambda_recursion(p_bfr, n_stages)


def required_stages(p_bfr: float, tol: float = 1e-5, max_stages: int = 16) -> int:
    """Smallest stage count n with 0.5 - lambda_n <= tol."""
    for n in range(max_stages + 1):
        if debias_error(p_bfr, n) <= tol:
            return n
    raise ValueError(
        f"p_bfr={p_bfr} cannot reach tol={tol} within {max_stages} stages"
    )


def xor_fold(
    raw: torch.Tensor, n_stages: int = DEFAULT_STAGES, axis: int = -2
) -> torch.Tensor:
    """Fold 2^n_stages raw words into one debiased word along ``axis``.

    ``raw`` must have size 2^n_stages along ``axis``; integer dtype.  Each
    stage XORs adjacent pairs, exactly mirroring the MSXOR gate tree.
    """
    if raw.shape[axis] != (1 << n_stages):
        raise ValueError(
            f"axis {axis} must have size 2**{n_stages}={1 << n_stages}, "
            f"got shape {tuple(raw.shape)}"
        )
    out = torch.movedim(raw, axis, -1)
    for _ in range(n_stages):
        out = out[..., 0::2] ^ out[..., 1::2]
    return out[..., 0]


def debias_bits(raw_bits: torch.Tensor, n_stages: int = DEFAULT_STAGES):
    """Debias a trailing-axis group of raw *bit* arrays.

    raw_bits: (..., 2^n_stages, W) uint8 in {0,1}  ->  (..., W) uint8.
    """
    return xor_fold(raw_bits, n_stages=n_stages, axis=-2)


def pack_bits_to_uint(bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., nbits) {0,1} -> (...,) uint32 words (int64), bit 0 least
    significant."""
    if bits.shape[-1] != nbits:
        raise ValueError(f"expected trailing dim {nbits}, got {tuple(bits.shape)}")
    weights = 1 << torch.arange(nbits, dtype=torch.int64, device=bits.device)
    return torch.sum(bits.to(torch.int64) * weights, dim=-1)


def unpack_uint_to_bits(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """(...,) uint words -> (..., nbits) uint8, bit 0 least significant."""
    shifts = torch.arange(nbits, dtype=torch.int64, device=words.device)
    return ((words[..., None].to(torch.int64) >> shifts) & 1).to(torch.uint8)


def empirical_lambda(bits) -> float:
    """Monte-Carlo estimate of P(bit = 1) for validation benchmarks: the
    float64 mean of ``bits`` (a tensor is copied to the host)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return float(np.asarray(bits, dtype=np.float64).mean())
