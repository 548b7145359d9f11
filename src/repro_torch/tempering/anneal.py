"""Simulated annealing on the engine — a monotone beta schedule plus a
best-state tracker (the PyTorch port of ``repro.tempering.anneal``).

Annealing is the 1-replica limit of tempering: one chain samples
p(x)^beta_k through the engine while beta_k rises stage by stage.  Each
stage is an engine segment submitted with ``step0 = <absolute step>``,
so the annealed stream is a pure function of (key, schedule), invariant
to ``chunk_steps`` and the executor, and a 1-stage schedule at beta = 1
is a plain engine run.

The best-state tracker is streaming: per independent chain element it
keeps only (best words, best beta = 1 log-prob) across every visited
state, O(state) memory regardless of ``n_steps``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.samplers import MHEngine, RunPlan
from repro_torch.samplers.engine import _acceptance_rate
from repro_torch.tempering.ladder import base_log_prob, scaled_target


@dataclasses.dataclass
class AnnealResult:
    best_words: torch.Tensor       # (*chain_shape,) best state ever visited
    best_logp: torch.Tensor        # (*elem,) its beta=1 log-prob (-energy)
    final_words: torch.Tensor      # (*chain_shape,) end-of-schedule state
    accept_count: torch.Tensor     # (*chain_shape,) pooled over stages
    acceptance_rate: torch.Tensor  # scalar float32
    n_steps: int
    betas: tuple[float, ...]

    @property
    def best_energy(self) -> torch.Tensor:
        """Natural-units energy of the best state (lattice targets)."""
        return -self.best_logp


def _stage_best(samples: torch.Tensor, f: torch.Tensor):
    """Per-element argmax of f over a stage's (T, *elem[, *site]) block;
    the first maximum wins, as ``jnp.argmax``'s."""
    t = f.shape[0]
    elem_shape = f.shape[1:]
    site_shape = samples.shape[f.ndim:]
    flat_f = f.reshape(t, -1)
    idx = torch.argmax(flat_f, dim=0)                      # (E,)
    cols = torch.arange(flat_f.shape[1], device=f.device)
    best_f = flat_f[idx, cols].reshape(elem_shape)
    flat_s = samples.reshape(t, flat_f.shape[1], -1)
    best_words = flat_s[idx, cols].reshape(*elem_shape, *site_shape)
    return best_words, best_f


@dataclasses.dataclass(frozen=True)
class Annealer:
    """Monotone (non-decreasing) beta schedule, ``steps_per_beta`` engine
    steps per stage; ``betas[-1]`` is the coldest/greediest stage."""

    betas: tuple[float, ...]
    steps_per_beta: int

    def __post_init__(self):
        if len(self.betas) < 1:
            raise ValueError("annealing schedule needs at least one beta")
        if self.steps_per_beta < 1:
            raise ValueError(f"steps_per_beta must be >= 1, got {self.steps_per_beta}")
        for b in self.betas:
            if not (math.isfinite(b) and b > 0.0):
                raise ValueError(f"betas must be finite and > 0, got {b}")
        for cur, nxt in zip(self.betas, self.betas[1:]):
            if nxt < cur:
                raise ValueError(
                    f"annealing betas must be non-decreasing (cooling), got {self.betas}"
                )

    @property
    def n_steps(self) -> int:
        return len(self.betas) * self.steps_per_beta

    @classmethod
    def geometric(
        cls, num_stages: int, steps_per_beta: int,
        beta_min: float = 0.25, beta_max: float = 4.0,
    ) -> "Annealer":
        if num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        if num_stages == 1:
            return cls((beta_max,), steps_per_beta)
        r = (beta_max / beta_min) ** (1.0 / (num_stages - 1))
        return cls(tuple(beta_min * r**i for i in range(num_stages)), steps_per_beta)

    @classmethod
    def linear(
        cls, num_stages: int, steps_per_beta: int,
        beta_min: float = 0.25, beta_max: float = 4.0,
    ) -> "Annealer":
        if num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        if num_stages == 1:
            return cls((beta_max,), steps_per_beta)
        step = (beta_max - beta_min) / (num_stages - 1)
        return cls(tuple(beta_min + step * i for i in range(num_stages)), steps_per_beta)

    def run(self, key, target, init_words, *, engine: MHEngine, chain_id: int = 0) -> AnnealResult:
        """Anneal from ``init_words`` through the schedule; returns the
        best state ever visited alongside the final one."""
        if engine.config.num_chains != 1:
            raise ValueError(
                "annealing drives a single chain per element; batch the "
                f"target/init instead of num_chains={engine.config.num_chains}"
            )
        state = engine._words(init_words)
        key = engine._key(key)
        best_words = best_f = acc = None
        step = 0
        for beta in self.betas:
            # the best tracker folds over every visited state, so stage
            # runs pin collect="all" whatever the engine's default is
            res = engine.submit(
                RunPlan(
                    target=scaled_target(target, beta), n_steps=self.steps_per_beta,
                    init_words=state, key=key, chain_id=chain_id, step0=step,
                    collect="all",
                )
            ).result
            f = base_log_prob(target, res.samples).to(torch.float32)
            stage_words, stage_f = _stage_best(res.samples, f)
            if best_f is None:
                best_words, best_f = stage_words, stage_f
            else:
                better = stage_f > best_f
                best_f = torch.where(better, stage_f, best_f)
                trail = best_words.ndim - better.ndim
                best_words = torch.where(
                    better.reshape(*better.shape, *([1] * trail)), stage_words, best_words,
                )
            state = res.final_words
            acc = res.accept_count if acc is None else acc + res.accept_count
            step += self.steps_per_beta
        return AnnealResult(
            best_words=best_words,
            best_logp=best_f,
            final_words=state,
            accept_count=acc,
            acceptance_rate=_acceptance_rate(acc, self.n_steps),
            n_steps=self.n_steps,
            betas=self.betas,
        )
