"""Entry points of the fused MH kernels for the engine.

The PyTorch counterpart of ``repro.kernels.mh.ops``.  The JAX version
pads the chain axis to a 128-lane multiple for the TPU; the CUDA kernels
mask their ragged edge themselves, so nothing is padded here.
``mh_sample`` is the raw kernel entry (randomness as operands);
``mh_sample_with_rng`` draws the paper-faithful randomness and runs it;
``sample_tokens_fused`` is the one-call token sampler over the engine.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.kernels.mh.mh import mh_chain, mh_chain_fused


def mh_sample(table, init, flips, u, nbits: int, block_c: int | None = None):
    """One chunk of K steps, randomness as operands (``host``/``cim``);
    returns every step's state and the per-chain accept counts.
    ``block_c`` is the TPU kernel's lane block, accepted for the JAX
    signature and ignored: the CUDA kernel picks its chain tile itself
    (``csrc/mh.cu:chain_tile_log``)."""
    del block_c
    return mh_chain(table, init, flips, u, nbits)


def mh_sample_fused(
    table, init, k0c, k1c, *, n_steps: int, t0, nbits: int, p_bfr: float, cc: int,
    block_c: int | None = None,
):
    """One chunk with in-kernel randomness (``fused``).  ``t0`` is an int
    or a per-column (C,) tensor of absolute-step bases — a runtime operand,
    so columns at different stream offsets share one launch; ``cc`` is the
    per-chain column count.  An int is filled in on the device: a copy from
    the host would wait for the card, and the engine's chunk loop could not
    run ahead.  ``block_c`` is ignored, as in ``mh_sample``."""
    del block_c
    c = init.shape[-1]
    if isinstance(t0, (int, np.integer)):
        t0c = torch.full((c,), int(t0), dtype=torch.int64, device=init.device)
    else:
        t0c = torch.as_tensor(t0, dtype=torch.int64, device=init.device).expand(c).contiguous()
    return mh_chain_fused(
        table, init, k0c, k1c, t0c, nbits=nbits, n_steps=n_steps, cc=cc,
        p_u32=rng.threshold_u32(p_bfr),
    )


class MHRandomness(NamedTuple):
    flips: torch.Tensor  # (K, B, C) uint32 biased flip words as int64
    u: torch.Tensor      # (K, B, C) float32 MSXOR-debiased uniforms


def generate_randomness(
    key, n_steps: int, batch: int, chains: int, p_bfr: float, rng_stages: int = 3,
) -> MHRandomness:
    """Paper-faithful randomness: pseudo-read bit-planes + MSXOR uniforms,
    on the key's device.

    A thin materialising wrapper over ``samplers.CIMRandomness`` (32-bit
    flip words and uniforms, steps from 0, the ``(k_flip, k_u)`` step-key
    split), so kernel-level callers and the engine draw the same stream.
    The whole (K, B, C) block is made up front: long chains should stream
    chunks through the backend instead."""
    from repro_torch.samplers.randomness import CIMRandomness  # samplers imports us

    backend = CIMRandomness(
        p_bfr=p_bfr, rng_p_bfr=p_bfr, rng_bit_width=32, rng_stages=rng_stages,
    )
    key = torch.as_tensor(key, dtype=torch.int64)
    flips, u = backend.chunk(key, 0, n_steps, (batch, chains), nbits=32)
    return MHRandomness(flips=flips, u=u)


def mh_sample_with_rng(
    key, table, n_steps: int, chains: int = 1, p_bfr: float = 0.45, rng_stages: int = 3,
    init=None, nbits: int | None = None,
):
    """End-to-end sampling from a (B, V) log-prob table on the table's
    device: the row argmax as init unless given, ``nbits = ceil(log2 V)``
    unless given, ``generate_randomness``'s block, then ``mh_sample`` (the
    operand kernel on a CUDA table, its plain version on a CPU one)."""
    b, vocab = table.shape
    if nbits is None:
        nbits = max(1, math.ceil(math.log2(vocab)))
    if init is None:
        init = torch.argmax(table, dim=-1)[:, None].expand(b, chains)
    init = torch.as_tensor(init, device=table.device).to(torch.int64).contiguous()
    rnd = generate_randomness(
        torch.as_tensor(key, device=table.device), n_steps, b, chains, p_bfr, rng_stages,
    )
    return mh_sample(table, init, rnd.flips, rnd.u, nbits=nbits)


def sample_tokens_fused(
    key, logits, n_steps: int = 64, temperature: float = 1.0, p_bfr: float = 0.45,
    prev_tokens=None, device=None,
):
    """Serving-path token sampler: one MH chain per batch row, through an
    engine with ``execution="pallas"`` (the MH kernels).  ``device`` is
    the engine's (the card unless ``"cpu"`` is asked for); ``logits`` must
    live there.  Returns (tokens (B,) int32, acceptance_rate scalar)."""
    from repro_torch import samplers  # samplers imports this module

    engine = samplers.MHEngine(
        samplers.EngineConfig(p_bfr=p_bfr, execution="pallas"), device=device,
    )
    tokens, result = engine.sample_tokens(
        key, logits, n_steps=n_steps, temperature=temperature, init_tokens=prev_tokens,
    )
    return tokens, result.acceptance_rate
