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
goes to the card.  As the JAX package jits ``_sample_tokens_impl``, the
port compiles it: on the card each signature's sample is a CUDA graph,
captured once and then replayed (``repro_torch.compiled``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch._guards import detect_fake_mode

from repro_torch import compiled, samplers
from repro_torch.distributed import sharding


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


# --- the compiled program ------------------------------------------------------
#
# The JAX package jits ``_sample_tokens_impl`` with ``cfg`` static: one
# program for each config and input layout, in one cache for the process.
# The port keeps one ``repro_torch.compiled`` program for each
# ``Signature`` in ``_PROGRAMS``: on the card a CUDA graph of the whole
# sample (the target, the argmax start, the chain with its randomness and
# the decode), captured once and replayed by one graph launch; on the CPU
# the signature only.  Each program holds the engine it captured with,
# whose tensors' addresses its graph bakes in.

_PROGRAMS: dict = {}


class Signature(NamedTuple):
    """JAX's static ``cfg`` (by value, as JAX hashes a static argument),
    the device, and the (shape, dtype) of ``key``, of ``logits`` and of
    ``init_tokens`` (None when absent)."""

    cfg: TokenSamplerConfig
    device: str
    key: tuple
    logits: tuple
    init_tokens: tuple | None


def cache_size() -> int:
    """The number of compiled programs: the counterpart of JAX's
    ``_sample_tokens_impl._cache_size()``."""
    return len(_PROGRAMS)


def clear_cache() -> None:
    """Drop every compiled program, its graph and the engine it holds."""
    _PROGRAMS.clear()


def _sample(engine, cfg: TokenSamplerConfig, key, logits, init_tokens) -> TokenSampleResult:
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


def _as_tensor(x, dtype=None):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x) if dtype is None else np.asarray(x).astype(dtype))


def _sample_tokens_impl(
    key,
    logits,
    cfg: TokenSamplerConfig,
    init_tokens=None,
) -> TokenSampleResult:
    """One token per row of ``logits`` through the compiled program of
    this call's signature.  The inputs are copied into the program's
    static buffers (a strided view of the logits too), and the outputs
    are clones: a later call never changes a result already handed out.
    A failed capture or replay raises ``RuntimeError`` naming the
    signature.  Under a fake tensor mode (a dry run traces the step) or
    with DTensor inputs the sample runs directly, with a fresh engine,
    and nothing is kept."""
    if not isinstance(logits, torch.Tensor):
        device = samplers.engine.resolve_device(None)
        logits = torch.as_tensor(logits, dtype=torch.float32, device=device)
    inputs = (_as_tensor(key, np.int64), logits, _as_tensor(init_tokens, np.int64))
    device = logits.device
    if detect_fake_mode(inputs) is not None or any(map(sharding.is_dtensor, inputs)):
        return _sample(samplers.MHEngine(cfg.engine_config(), device=device), cfg, *inputs)
    sig = Signature(cfg, str(device), *(compiled.layout(x) for x in inputs))
    program = _PROGRAMS.get(sig)
    engine = (samplers.MHEngine(cfg.engine_config(), device=device) if program is None
              else program.holds)
    result, _ = compiled.call(
        _PROGRAMS, sig, functools.partial(_sample, engine, cfg), inputs, device,
        f"token sampler {sig}", holds=engine, name="engine.sample_tokens",
    )
    return result


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
