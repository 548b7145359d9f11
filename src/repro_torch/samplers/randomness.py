"""Randomness axis of the sampler engine — where the MH random bits come from.

The PyTorch counterpart of ``repro.samplers.randomness``.  One MH step
consumes two random operands per chain (paper Fig. 14): a *flip word*
whose low ``nbits`` bit-planes are i.i.d. Bernoulli(p_BFR), and a uniform
``u`` in [0, 1).  Three backends draw them:

  * ``HostRandomness``  — ideal software randomness (the ``jax.random``
    stream, reproduced by ``repro_torch.prng``).
  * ``CIMRandomness``   — the paper's circuit pipeline: pseudo-read
    bit-planes for the proposal, reset -> pseudo-read -> MSXOR -> pack
    for ``u``.
  * ``FusedRandomness`` — the counter cipher the fused CUDA kernel draws
    from in-kernel; ``chunk`` materialises the identical stream for the
    scan executor.

Chunked streaming contract: the operands of absolute step ``t`` depend
only on ``(key, t)`` — host/cim fold ``t`` into the key, fused folds it
into the cipher counter — so any chunking yields the same stream.
``need_flips=False`` returns ``(None, u)`` with an unchanged u stream.
Operands land on the key's device.  A start is an int or a 0-d int64
tensor on the key's device (JAX's draw takes a traced start): the same
start draws the same bits either way, and a tensor start is never read
on the host, so a draw at a step held on the card can be captured.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch import prng
from repro_torch.core import bitcell, uniform_rng
from repro_torch.kernels import rng


def chain_key(key: torch.Tensor, chain_id) -> torch.Tensor:
    """Counter-based per-chain key: ``fold_in(key, chain_id)``, so chain c
    of a C-chain run is bit-identical to a solo run with ``chain_id=c``."""
    return prng.fold_in(key, chain_id)


def chain_keys(key: torch.Tensor, num_chains: int, base: int = 0) -> torch.Tensor:
    """Stacked (num_chains, 2) keys for chains [base, base + num_chains)."""
    ids = base + torch.arange(num_chains, dtype=torch.int64, device=key.device)
    return prng.fold_in(key, ids)


def _steps(start, n_steps: int, device) -> torch.Tensor:
    """Absolute steps [start, start + n) as int64 on ``device``; ``start``
    an int or a 0-d int64 tensor there."""
    base = start if isinstance(start, torch.Tensor) else int(start)
    return base + torch.arange(n_steps, dtype=torch.int64, device=device)


def step_keys(key: torch.Tensor, start, n_steps: int) -> torch.Tensor:
    """(n_steps, 2) per-step keys for absolute steps [start, start + n)."""
    return prng.fold_in(key, _steps(start, n_steps, key.device))


@runtime_checkable
class RandomnessBackend(Protocol):
    """Produces the (flips, u) operand stream for a span of MH steps."""

    name: str

    def chunk(
        self, key, start, n_steps: int, shape: tuple, nbits: int,
        need_flips: bool = True,
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """Operands for steps [start, start + n_steps): flips
        (n_steps, *shape) uint32 words as int64, u (n_steps, *shape)
        float32; ``(None, u)`` under ``need_flips=False``."""
        ...


def _split_step_keys(key, start, n_steps):
    """(k_flip, k_u) per step: the step key split before either operand
    is drawn, so the u stream never depends on the flips."""
    ks = prng.split(step_keys(key, start, n_steps))
    return ks[:, 0], ks[:, 1]


@dataclasses.dataclass(frozen=True)
class HostRandomness:
    """Ideal software randomness — the baseline the CIM pipeline replaces."""

    p_bfr: float = 0.45

    name = "host"

    def chunk(self, key, start, n_steps, shape, nbits, need_flips=True):
        k_flip, k_u = _split_step_keys(key, start, n_steps)
        u = prng.uniform(k_u, shape)
        if not need_flips:
            return None, u
        planes = prng.bernoulli(k_flip, self.p_bfr, (*shape, nbits))
        weights = 1 << torch.arange(nbits, dtype=torch.int64, device=key.device)
        return torch.sum(planes.to(torch.int64) * weights, dim=-1), u


@dataclasses.dataclass(frozen=True)
class CIMRandomness:
    """Paper-faithful randomness: pseudo-read bit-planes + MSXOR uniforms."""

    p_bfr: float = 0.45            # proposal pseudo-read flip rate
    rng_p_bfr: float = 0.45        # [0,1]-RNG sub-array raw-bit bias
    rng_bit_width: int = 16        # packed debiased bits per uniform
    rng_stages: int = 3            # MSXOR fold stages

    name = "cim"

    def chunk(self, key, start, n_steps, shape, nbits, need_flips=True):
        k_flip, k_u = _split_step_keys(key, start, n_steps)
        u = uniform_rng.uniform(
            k_u, shape, self.rng_p_bfr, self.rng_bit_width, self.rng_stages
        )
        if not need_flips:
            return None, u
        flips = bitcell.raw_random_words(k_flip, self.p_bfr, shape, nbits=nbits)
        return flips, u


@dataclasses.dataclass(frozen=True)
class FusedRandomness:
    """The in-kernel counter stream, materialised for the scan executor:
    operand at (chain, step t, site s) = Threefry-2x32 of the ``(t, s)``
    counter under the chain key's two words, salted per operand — the
    draws ``mh_chain_fused`` makes inside the kernel."""

    p_bfr: float = 0.45

    name = "fused"

    def chunk(self, key, start, n_steps, shape, nbits, need_flips=True):
        k0, k1 = rng.key_words(key)
        site = rng.site_index(shape, device=key.device)
        s0, s1 = rng.step_key(k0, k1, _steps(start, n_steps, key.device))
        s0 = s0.reshape(n_steps, *(1,) * len(shape))
        s1 = s1.reshape(n_steps, *(1,) * len(shape))
        u = rng.uniform_at(s0, s1, site)
        if not need_flips:
            return None, u
        return rng.flips_at(s0, s1, site, nbits, rng.threshold_u32(self.p_bfr)), u


def make_randomness_backend(
    name: str,
    p_bfr: float,
    rng_p_bfr: float | None = None,
    rng_bit_width: int = 16,
    rng_stages: int = 3,
) -> RandomnessBackend:
    if name == "host":
        return HostRandomness(p_bfr=p_bfr)
    if name == "cim":
        return CIMRandomness(
            p_bfr=p_bfr,
            rng_p_bfr=p_bfr if rng_p_bfr is None else rng_p_bfr,
            rng_bit_width=rng_bit_width,
            rng_stages=rng_stages,
        )
    if name == "fused":
        return FusedRandomness(p_bfr=p_bfr)
    raise ValueError(f"unknown randomness backend {name!r} (host|cim|fused)")
