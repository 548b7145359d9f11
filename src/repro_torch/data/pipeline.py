"""Deterministic, host-sharded synthetic token pipeline — the port of
``repro.data.pipeline``, batch for batch.

Every global batch is a pure function of ``(seed, step)``: a restart,
reshard or elastic rescale replays identical data.  A host materialises
only its slice ``[host_id * per_host, (host_id + 1) * per_host)`` of the
global batch, each row from its own key, so the global batch does not
depend on the host count.  The keys and draws are ``jax.random``'s, made
by ``repro_torch.prng``:

* ``UniformSource``: row ``r`` of step ``t`` is ``randint(fold_in(
  fold_in(PRNGKey(seed), t), r), (seq_len + 1,), 0, vocab)``;
* ``MarkovSource``: a fixed random first-order chain with ``branching``
  successors a state (its table from ``np.random.default_rng(seed +
  7919)``); a row's first token is ``randint(k0, (), 0, vocab)`` and
  step ``i`` draws ``categorical(split(k1, seq_len)[i], log(probs[state]))``
  (``k0, k1 = split(row key)``).  The Gumbel noise of a step does not
  depend on the state, so every row's and step's noise is drawn at once
  and only the argmax walks the chain.

The draws are bit for bit JAX's.  The logs are torch's (the Gumbel
noise's and ``log(probs)``), which differ from XLA's in the last bit for
a few per cent of their arguments: a token differs only where the two
best candidates of a draw lie within that bit of each other, a tie
event as the samplers' (``kernels/mh/ref.py:tie_events``).

Batches are int32 tensors on the pipeline's device (the card unless
``"cpu"`` is asked for).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.samplers.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "markov"          # markov | uniform
    branching: int = 16              # successors per state (markov)
    n_hosts: int = 1
    host_id: int = 0

    @property
    def per_host(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"{self.n_hosts} hosts"
            )
        return self.global_batch // self.n_hosts


def _row_keys(cfg: DataConfig, step: int, row_lo: int, row_hi: int, device) -> torch.Tensor:
    """One key a global row: (rows, 2)."""
    key = prng.fold_in(prng.PRNGKey(cfg.seed, device=device), int(step))
    return prng.fold_in(key, torch.arange(row_lo, row_hi, device=device))


class UniformSource:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch_rows(self, step: int, row_lo: int, row_hi: int) -> torch.Tensor:
        cfg = self.cfg
        keys = _row_keys(cfg, step, row_lo, row_hi, self.device)
        return prng.randint(keys, (cfg.seq_len + 1,), 0, cfg.vocab_size).to(torch.int32)


class MarkovSource:
    """First-order Markov chain with ``branching`` successors per state."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed + 7919)
        v, b = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
        successors = rng.integers(0, v, size=(v, b))  # (V, B) allowed next-tokens per state
        logits = rng.normal(size=(v, b))
        self.probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
        self.successors = torch.as_tensor(successors, dtype=torch.int64, device=self.device)
        self.log_probs = torch.log(torch.as_tensor(self.probs, device=self.device))

    def entropy_per_token(self) -> float:
        """Mean conditional entropy (nats) — the achievable CE floor."""
        p = self.probs
        return float(-(p * np.log(p)).sum(-1).mean())

    def batch_rows(self, step: int, row_lo: int, row_hi: int) -> torch.Tensor:
        cfg = self.cfg
        keys = _row_keys(cfg, step, row_lo, row_hi, self.device)
        ks = prng.split(keys)                                    # (rows, 2, 2)
        state = prng.randint(ks[:, 0], (), 0, cfg.vocab_size)    # (rows,)
        step_keys = prng.split(ks[:, 1], cfg.seq_len)           # (rows, T, 2)
        noise = prng.gumbel(step_keys, (self.log_probs.shape[1],))  # (rows, T, B)
        toks = [state]
        for t in range(cfg.seq_len):
            nxt = torch.argmax(noise[:, t] + self.log_probs[state], dim=-1)
            state = self.successors[state, nxt]
            toks.append(state)
        return torch.stack(toks, dim=1).to(torch.int32)


class SyntheticTokenPipeline:
    """Yields {tokens, labels} batches; deterministic in (seed, step)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        source = MarkovSource if cfg.source == "markov" else UniformSource
        self.source = source(cfg, device)

    def global_batch(self, step: int) -> dict:
        rows = self.source.batch_rows(step, 0, self.cfg.global_batch)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def host_batch(self, step: int) -> dict:
        cfg = self.cfg
        lo = cfg.host_id * cfg.per_host
        rows = self.source.batch_rows(step, lo, lo + cfg.per_host)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.host_batch(step)
            step += 1
