"""Entry points of the MSXOR debias kernel.

The PyTorch counterpart of ``repro.kernels.msxor.ops``.  The JAX version
pads M to a 128-lane block multiple for the TPU and strips the padding;
the CUDA kernel masks its ragged edge itself, so any M is taken as it is.
``block_m`` is accepted for the JAX signature and ignored.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.msxor.msxor import msxor


def msxor_fold(raw: torch.Tensor, n_stages: int = 3, block_m: int = 512) -> torch.Tensor:
    """Debias raw biased words: (G, M) uint32 -> (M,) uint32 (int64)."""
    del block_m
    return msxor(raw, n_stages=n_stages)


def msxor_uniform(raw: torch.Tensor, n_stages: int = 3, block_m: int = 512) -> torch.Tensor:
    """Fused debias + uniform conversion: (G, M) uint32 -> (M,) float32."""
    del block_m
    return msxor(raw, n_stages=n_stages, to_uniform=True)
