"""Softmax-free MCMC token sampling — the paper's technique in LLM decode;
the port of ``repro.core.token_sampler``.

The next-token id is treated as a ceil(log2 V)-bit word.  The proposal
flips each bit with p_BFR (the pseudo-read analogue); u comes from the
MSXOR debiased uniform RNG; the accept test uses only the *logit
difference* exp((l* - l)/T) — the paper's alpha = p(x*)/p(x^(i))
simplification.  No logsumexp over the vocabulary is ever computed.
Out-of-vocab proposals have p = 0 and are always rejected.

This module is an API-compatible wrapper over the sampler engine
(``repro_torch.samplers``): the chain lives there once, and the
``execution`` / ``randomness`` fields pick the executor (on the card,
``auto`` runs the MH chain kernel of ``csrc/mh.cu``) and the randomness
pipeline.  The engine runs where the logits are: a CUDA tensor on the
card, a CPU tensor on the CPU (the kernel's plain version); anything else
goes to the card.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import torch

from repro_torch import samplers


@dataclasses.dataclass(frozen=True)
class TokenSamplerConfig:
    vocab_size: int
    n_steps: int = 64                 # MH iterations per emitted token
    p_bfr: float = 0.45
    rng_bit_width: int = 24           # u precision (logit ratios can be tiny)
    rng_stages: int = 3
    temperature: float = 1.0
    top_k: int = 0                    # 0 = full vocab (paper-faithful);
                                      # >0 restricts the chain to top-k logits
    execution: str = "auto"           # auto | scan | pallas (engine dispatch)
    randomness: str = "cim"           # cim | host randomness backend
    chunk_steps: int = 64             # randomness streaming granularity

    @property
    def nbits(self) -> int:
        space = self.top_k if self.top_k > 0 else self.vocab_size
        return max(1, math.ceil(math.log2(space)))

    def engine_config(self) -> samplers.EngineConfig:
        return samplers.EngineConfig(
            p_bfr=self.p_bfr,
            randomness=self.randomness,
            rng_p_bfr=self.p_bfr,
            rng_bit_width=self.rng_bit_width,
            rng_stages=self.rng_stages,
            execution=self.execution,
            chunk_steps=self.chunk_steps,
        )


class TokenSampleResult(NamedTuple):
    tokens: torch.Tensor           # (batch,) int32 sampled token ids
    acceptance_rate: torch.Tensor  # scalar float32
    final_logp: torch.Tensor       # (batch,) float32 unnormalised log-prob


def _sample_tokens_impl(
    key,
    logits,
    cfg: TokenSamplerConfig,
    init_tokens=None,
) -> TokenSampleResult:
    if not isinstance(logits, torch.Tensor):
        device = samplers.engine.resolve_device(None)
        logits = torch.as_tensor(logits, dtype=torch.float32, device=device)
    engine = samplers.MHEngine(cfg.engine_config(), device=logits.device)
    tokens, result = engine.sample_tokens(
        key,
        logits,
        n_steps=cfg.n_steps,
        temperature=cfg.temperature,
        top_k=cfg.top_k,
        init_tokens=init_tokens,
    )
    return TokenSampleResult(
        tokens=tokens,
        acceptance_rate=result.acceptance_rate,
        final_logp=result.final_logp[:, 0],
    )


def sample_tokens(
    key,
    logits,
    cfg: TokenSamplerConfig,
    init_tokens=None,
) -> TokenSampleResult:
    """Draw one token per row of ``logits`` (B, V) via the CIM-MCMC chain.

    ``init_tokens`` seeds each chain; it defaults to the argmax, which
    guarantees a finite-logp start.

    .. deprecated:: the documented surface is ``MHEngine.sample_tokens``
       reached through ``repro_torch.samplers``; this wrapper gives the
       same stream.
    """
    warnings.warn(
        "core.token_sampler.sample_tokens is deprecated; configure an "
        "MHEngine via repro_torch.samplers and call engine.sample_tokens",
        DeprecationWarning,
        stacklevel=2,
    )
    return _sample_tokens_impl(key, logits, cfg, init_tokens)
