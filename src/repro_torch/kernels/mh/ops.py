"""Entry points of the fused MH kernels for the engine.

The PyTorch counterpart of ``repro.kernels.mh.ops``.  The JAX version
pads the chain axis to a 128-lane multiple for the TPU; the CUDA kernels
mask their ragged edge themselves, so nothing is padded here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.kernels.mh.mh import mh_chain, mh_chain_fused


def mh_sample(table, init, flips, u, nbits: int):
    """One chunk of K steps, randomness as operands (``host``/``cim``);
    returns every step's state and the per-chain accept counts."""
    return mh_chain(table, init, flips, u, nbits)


def mh_sample_fused(
    table, init, k0c, k1c, *, n_steps: int, t0, nbits: int, p_bfr: float, cc: int
):
    """One chunk with in-kernel randomness (``fused``).  ``t0`` is an int
    or a per-column (C,) tensor of absolute-step bases — a runtime operand,
    so columns at different stream offsets share one launch; ``cc`` is the
    per-chain column count.  An int is filled in on the device: a copy from
    the host would wait for the card, and the engine's chunk loop could not
    run ahead."""
    c = init.shape[-1]
    if isinstance(t0, (int, np.integer)):
        t0c = torch.full((c,), int(t0), dtype=torch.int64, device=init.device)
    else:
        t0c = torch.as_tensor(t0, dtype=torch.int64, device=init.device).expand(c).contiguous()
    return mh_chain_fused(
        table, init, k0c, k1c, t0c, nbits=nbits, n_steps=n_steps, cc=cc,
        p_u32=rng.threshold_u32(p_bfr),
    )
