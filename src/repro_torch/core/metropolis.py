"""Vectorised Metropolis–Hastings — paper Algorithm 1 + §3.2.

The PyTorch counterpart of ``repro.core.metropolis``.  The chain state is
a block of k-bit integer words, one word per compartment (the paper's
macro runs 64 compartments in lock-step; here the compartment axis is an
arbitrary batch shape).  Each step:

  1. candidate = pseudo-read bit-flip of the current word  (block-wise RNG)
  2. u ~ accurate [0,1] RNG                                 (MSXOR-debiased)
  3. accept iff u < min(1, p(x*) / p(x)) — q cancels by symmetry (paper §3.2)
  4. "in-memory copy": accepted candidates overwrite the state; rejected
     compartments re-copy the previous value (costed in the energy model)

This module is a thin, API-compatible wrapper over the port's sampler
engine (``repro_torch.samplers``): one ``engine.submit(RunPlan)`` on a
``CallableTarget`` with the scan executor.  Like every entry point of the
port it runs on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch import prng, samplers

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MHConfig:
    nbits: int = 4                    # sample precision (paper: 4..32, up to 64)
    p_bfr: float = 0.45               # proposal bit-flip rate (pseudo-read)
    rng_p_bfr: float = 0.45           # [0,1]-RNG raw-bit bias
    rng_stages: int = 3               # MSXOR stages
    rng_bit_width: int = 16           # u precision (>=8; 16 tightens the
                                      # accept test for peaked targets)
    burn_in: int = 500                # paper §2.1: empirical 500-1000
    thin: int = 1
    randomness: str = "cim"           # host | cim randomness backend
    chunk_steps: int = 64             # randomness streaming granularity

    def __post_init__(self):
        if not 1 <= self.nbits <= 32:
            raise ValueError(f"nbits must be in [1,32], got {self.nbits}")

    def engine_config(self) -> samplers.EngineConfig:
        return samplers.EngineConfig(
            p_bfr=self.p_bfr,
            randomness=self.randomness,
            rng_p_bfr=self.rng_p_bfr,
            rng_bit_width=self.rng_bit_width,
            rng_stages=self.rng_stages,
            execution="scan",          # callable targets: no table for the kernel
            chunk_steps=self.chunk_steps,
        )


class MHStepState(NamedTuple):
    words: torch.Tensor          # (...,) uint32 current samples (int64)
    log_prob: torch.Tensor       # (...,) float32 cached log p(x)
    accept_count: torch.Tensor   # (...,) int32


class MHResult(NamedTuple):
    samples: torch.Tensor          # (n_kept, ...) uint32 (int64)
    final: MHStepState
    n_steps: int
    acceptance_rate: torch.Tensor  # scalar float32


def _run_chain_impl(
    key,
    log_prob_fn: LogProbFn,
    cfg: MHConfig,
    n_samples: int,
    chain_shape: tuple = (),
    init_words=None,
    device=None,
) -> MHResult:
    engine = samplers.MHEngine(cfg.engine_config(), device=device)
    key = engine._key(key)
    if init_words is None:
        k_init, key = prng.split(key)
        init_words = prng.randint(k_init, chain_shape, 0, 1 << cfg.nbits, dtype="uint32")
    else:
        init_words = engine._words(init_words).expand(chain_shape)

    n_steps = cfg.burn_in + n_samples * cfg.thin
    target = samplers.CallableTarget(log_prob_fn, cfg.nbits)
    res = engine.submit(
        samplers.RunPlan(target=target, n_steps=n_steps, init_words=init_words, key=key)
    ).result

    kept = res.samples[cfg.burn_in:]
    if cfg.thin > 1:
        kept = kept[cfg.thin - 1::cfg.thin]

    return MHResult(
        samples=kept,
        final=MHStepState(
            words=res.final_words,
            log_prob=res.final_logp,
            accept_count=res.accept_count,
        ),
        n_steps=n_steps,
        acceptance_rate=res.acceptance_rate,
    )


def run_chain(
    key,
    log_prob_fn: LogProbFn,
    cfg: MHConfig,
    n_samples: int,
    chain_shape: tuple = (),
    init_words=None,
    device=None,
) -> MHResult:
    """Run MH and keep ``n_samples`` post-burn-in (thinned) states per chain.

    Total iterations = burn_in + n_samples * thin.  Samples are the *chain
    states* after each kept step (MH output convention: a rejected step
    re-emits the previous value — exactly the macro's re-copy behaviour).

    .. deprecated:: build a ``samplers.RunPlan`` and call
       ``MHEngine.submit(plan)`` instead; this wrapper stays bit-compatible
       but only covers the burn-in/thin convenience slice of the engine
       surface.
    """
    warnings.warn(
        "core.metropolis.run_chain is deprecated; build a samplers.RunPlan "
        "and call engine.submit(plan)",
        DeprecationWarning,
        stacklevel=2,
    )
    return _run_chain_impl(
        key, log_prob_fn, cfg, n_samples, chain_shape, init_words, device=device
    )


def effective_sample_count(result: MHResult) -> int:
    return int(result.samples.shape[0]) * int(max(1, result.samples[0].numel()))
