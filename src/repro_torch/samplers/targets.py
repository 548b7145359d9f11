"""Target axis of the sampler engine — what distribution the chain samples.

The PyTorch counterpart of ``repro.samplers.targets``:

  * ``CallableTarget``  — a log-prob function over k-bit words (scan
    execution only).
  * ``TableTarget``     — a (B, V) table of unnormalised log-probs; B
    independent targets, each sampled by C chains.  The fused kernel's
    target.
  * ``TopKTarget``      — a TableTarget over each row's top-k logits;
    ``decode`` maps chain words back to vocabulary ids.

The table lookup clamps the index for the gather, then gives -inf to
words >= V, exactly as the kernels do, so executors agree bit for bit.
Words are uint32 values carried in int64 tensors.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.kernels.mh.ref import table_log_prob

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


class CallableTarget:
    """log p given as a function over integer words; any chain shape."""

    table: torch.Tensor | None = None

    def __init__(self, log_prob_fn: LogProbFn, nbits: int):
        if not 1 <= nbits <= 32:
            raise ValueError(f"nbits must be in [1,32], got {nbits}")
        self.log_prob_fn = log_prob_fn
        self.nbits = nbits

    def log_prob(self, words: torch.Tensor) -> torch.Tensor:
        return self.log_prob_fn(words)

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        return words


class TableTarget:
    """log p given as a (B, V) float32 table; chain state has shape (B, C).

    The table stays on the device it was given on: the engine raises if
    that is not its own device.  It is kept contiguous, as the kernels
    read it.
    """

    def __init__(self, table, nbits: int | None = None):
        table = torch.as_tensor(table, dtype=torch.float32).contiguous()
        if table.ndim != 2:
            raise ValueError(f"table must be (B, V), got {tuple(table.shape)}")
        self.table = table
        self.vocab = table.shape[-1]
        self.nbits = nbits or max(1, math.ceil(math.log2(self.vocab)))

    def log_prob(self, words: torch.Tensor) -> torch.Tensor:
        return table_log_prob(self.table, words)

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        return words.to(torch.int32)


def _divide(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """``x / float32(temperature)`` elementwise: a full tensor divisor, so
    no backend swaps the division for a reciprocal multiply."""
    return x / torch.full_like(x, temperature)


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: descending values, the lower index first on
    ties (a stable sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class TopKTarget(TableTarget):
    """TableTarget over each row's top-k logits; decode maps back to ids."""

    def __init__(self, logits, top_k: int, temperature: float = 1.0):
        logits = torch.as_tensor(logits, dtype=torch.float32)
        if not 0 < top_k <= logits.shape[-1]:
            raise ValueError(
                f"top_k must be in (0, V={logits.shape[-1]}], got {top_k}"
            )
        top_vals, top_idx = _top_k(logits, top_k)
        super().__init__(_divide(top_vals, temperature))
        self.top_idx = top_idx

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.top_idx, -1, words.to(torch.int64)).to(torch.int32)


def logits_target(logits, temperature: float = 1.0, top_k: int = 0) -> TableTarget:
    """The token-sampling target: full-vocab table or top-k restriction."""
    if top_k > 0:
        return TopKTarget(logits, top_k, temperature)
    return TableTarget(_divide(torch.as_tensor(logits, dtype=torch.float32), temperature))
