"""Plain PyTorch versions of the MSXOR debias kernel.

The counterpart of ``repro.kernels.msxor.ref`` and the plain version of
``csrc/msxor.cu``.  Words are uint32 values held in int64 tensors; int32
bit patterns are accepted too and read as the same 32 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def msxor_fold_ref(raw: torch.Tensor, n_stages: int) -> torch.Tensor:
    """raw: (G, M) uint32 words with G == 2**n_stages -> (M,) debiased
    words (int64).

    Stage i XORs adjacent word pairs, exactly the paper's MSXOR gate tree
    (Fig. 9(a)): 8 raw words R0^0..R0^7 -> 4 -> 2 -> 1.
    """
    if raw.shape[0] != (1 << n_stages):
        raise ValueError(
            f"leading dim must be 2**{n_stages}={1 << n_stages}, got {tuple(raw.shape)}"
        )
    out = raw.to(torch.int64) & MASK32
    for _ in range(n_stages):
        out = out[0::2] ^ out[1::2]
    return out[0]


def msxor_uniform_ref(raw: torch.Tensor, n_stages: int) -> torch.Tensor:
    """Debiased words -> u in [0, 1): the top 24 bits scaled by 2^-24,
    exact in float32."""
    words = msxor_fold_ref(raw, n_stages)
    return (words >> 8).to(torch.float32) * 2.0**-24
