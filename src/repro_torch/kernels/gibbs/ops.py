"""Entry points of the checkerboard Gibbs kernels for the engine.

The PyTorch counterpart of ``repro.kernels.gibbs.ops``, with the JAX
signatures except that the conditional arrives as one logit spec
(``ref.IsingLogit`` / ``ref.SpinGlassLogit``, couplings included) where
JAX passes ``logit_fn`` and its ``consts``.  ``parity0`` and ``t0`` are an
int or a per-lattice (B,) tensor: runtime operands, so lattices at
different absolute steps share one call.  A periodic lattice is never
padded.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gibbs.gibbs import gibbs_chain, gibbs_chain_fused


def _per_lattice(x, init: torch.Tensor) -> torch.Tensor:
    """An int or a (B,) tensor as a (B,) int64 tensor on the lattice's
    device.  An int is filled in on the device: a copy from the host would
    wait for the card, and the engine's chunk loop could not run ahead."""
    b = init.shape[0]
    if isinstance(x, (int, np.integer)):
        return torch.full((b,), int(x), dtype=torch.int64, device=init.device)
    return torch.as_tensor(x, dtype=torch.int64, device=init.device).expand(b).contiguous()


def gibbs_sweep(init, u, logit, parity0=0):
    """K half-sweeps from ``init`` (B, H, W) with the (K, B, H, W) uniforms
    ``u`` (one per site per half-sweep; the inactive colour's are
    discarded, so the stream stays aligned with the scan executor).
    Returns (samples (K, B, H, W) int32 spins, flips (B, H, W) int32)."""
    return gibbs_chain(init, u, logit, _per_lattice(parity0, init))


def gibbs_sweep_fused(init, k0b, k1b, logit, *, n_steps: int, t0, lat_b: int):
    """K half-sweeps with in-kernel uniforms (``fused``): ``k0b``/``k1b``
    are the per-lattice chain-key words, ``t0`` the absolute step of the
    first half-sweep (it carries the parity), ``lat_b`` the per-chain
    lattice count (solo callers pass ``init.shape[0]``).  Returns int32
    samples and flips, as ``gibbs_sweep``."""
    return gibbs_chain_fused(
        init, k0b, k1b, _per_lattice(t0, init), logit, n_steps=int(n_steps),
        lat_b=int(lat_b),
    )
