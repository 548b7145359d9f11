"""Temperature ladders — the beta axis above the sampler engine (the
PyTorch port of ``repro.tempering.ladder``).

A replica at inverse temperature ``beta`` samples the flattened measure
p(x)^beta, obtained purely by scaling the target's logits: the table /
callable log-prob under ``mh``, the conditional logit under ``gibbs``
(p^beta's single-site conditional logit is exactly beta times the base
one).  ``Ladder`` owns the beta schedule and builds the per-replica
scaled targets; the exchange and anneal drivers run each replica as one
slot of the engine's chain-id axis.

The Gibbs kernels cannot trace a closure, so a tempered lattice hands
them its conditional as the base model's logit spec with ``scale =
float32(beta)`` (``kernels/gibbs/ref.py``): the scan executor, the plain
versions and both CUDA specialisations multiply it in last, as the JAX
package's ``TemperedLattice`` does.

``scaled_target(target, 1.0)`` returns the base target itself, so a
1-replica ladder is a plain engine run by identity.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch import samplers


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class TemperedLattice:
    """A conditional lattice model flattened to p^beta.

    ``logit_spec`` is the base model's spec with ``scale =
    float32(beta)``, and ``conditional_logit`` calls it, so the scan
    executor and the kernels compute one formula, ``float32(beta) *
    logit``.  Everything else (``update_mask``, ``energy``, ``decode``,
    observables) delegates to the base model: they are the beta = 1
    statistics.
    """

    base: object
    beta: float

    nbits = 1
    table = None

    def __post_init__(self):
        if not (math.isfinite(self.beta) and self.beta > 0.0):
            raise ValueError(f"beta must be finite and > 0, got {self.beta}")

    @property
    def supports_fused_gibbs(self) -> bool:
        return getattr(self.base, "supports_fused_gibbs", False)

    @property
    def logit_spec(self):
        spec = self.base.logit_spec
        if spec.scale != 1.0:
            raise ValueError(
                "a tempered lattice's conditional carries one scale; temper the "
                f"base model instead of a tempered one (base scale {spec.scale})"
            )
        return dataclasses.replace(spec, scale=_f32(self.beta))

    def conditional_logit(self, state: torch.Tensor) -> torch.Tensor:
        return self.logit_spec(state)

    def __getattr__(self, name):
        # update_mask / energy / decode / observables pass through
        if name == "base":  # not yet set (unpickling): avoid recursion
            raise AttributeError(name)
        return getattr(self.base, name)


class _ScaledTable(samplers.TableTarget):
    """A log-prob table flattened to p^beta: ``float32(beta) * table``, as
    the JAX package computes it, on the table's device; ``decode`` keeps
    the base's word mapping (e.g. ``TopKTarget`` ids)."""

    def __init__(self, base, beta: float):
        scale = torch.full((), _f32(beta), dtype=torch.float32, device=base.table.device)
        super().__init__(scale * base.table, nbits=base.nbits)
        self.base = base

    def decode(self, words):
        return self.base.decode(words)


def _scaled_log_prob(target, beta: float):
    def log_prob(words):
        lp = target.log_prob(words)
        return torch.full((), _f32(beta), dtype=lp.dtype, device=lp.device) * lp

    return log_prob


def scaled_target(target, beta: float):
    """The beta-tempered view of ``target``: samples p^beta.

    ``beta == 1.0`` returns ``target`` itself, so an untempered replica
    is the plain run.
    """
    beta = float(beta)
    if not (math.isfinite(beta) and beta > 0.0):
        raise ValueError(f"beta must be finite and > 0, got {beta}")
    if beta == 1.0:
        return target
    if hasattr(target, "conditional_logit"):
        return TemperedLattice(target, beta)
    if getattr(target, "table", None) is not None:
        return _ScaledTable(target, beta)
    return samplers.CallableTarget(_scaled_log_prob(target, beta), target.nbits)


def base_log_prob(target, words):
    """Joint beta = 1 log-prob per *independent chain element* — the swap
    and best-state statistic.

    Log-prob targets score each word independently, so the element shape
    is the state shape.  Conditional lattice models have no per-site
    joint; they must expose ``energy`` (natural units, p ∝ exp(-E)), and
    the element is the whole lattice — one (H, W) configuration swaps as
    a unit.
    """
    if hasattr(target, "conditional_logit"):
        energy = getattr(target, "energy", None)
        if energy is None:
            raise ValueError(
                "tempering a lattice model needs a joint ``energy`` method "
                "(natural units, p ∝ exp(-E)); "
                f"{type(target).__name__} has none"
            )
        return -energy(words)
    return target.log_prob(words)


@dataclasses.dataclass(frozen=True)
class Ladder:
    """An inverse-temperature ladder; ``betas[0]`` is the cold/target
    replica, later entries are progressively flatter (non-increasing)."""

    betas: tuple[float, ...]

    def __post_init__(self):
        if len(self.betas) < 1:
            raise ValueError("ladder needs at least one beta")
        for b in self.betas:
            if not (math.isfinite(b) and b > 0.0):
                raise ValueError(f"betas must be finite and > 0, got {b}")
        for hot, hotter in zip(self.betas, self.betas[1:]):
            if hotter > hot:
                raise ValueError(
                    "ladder betas must be non-increasing (betas[0] is the "
                    f"cold/target replica), got {self.betas}"
                )

    @property
    def num_replicas(self) -> int:
        return len(self.betas)

    @classmethod
    def geometric(
        cls, num_replicas: int, beta_min: float = 0.25, beta_max: float = 1.0
    ) -> "Ladder":
        """Geometric spacing — the standard parallel-tempering default."""
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if num_replicas == 1:
            return cls((beta_max,))
        r = (beta_min / beta_max) ** (1.0 / (num_replicas - 1))
        return cls(tuple(beta_max * r**i for i in range(num_replicas)))

    @classmethod
    def linear(
        cls, num_replicas: int, beta_min: float = 0.25, beta_max: float = 1.0
    ) -> "Ladder":
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if num_replicas == 1:
            return cls((beta_max,))
        step = (beta_max - beta_min) / (num_replicas - 1)
        return cls(tuple(beta_max - step * i for i in range(num_replicas)))

    def targets(self, base_target) -> tuple:
        """Per-replica scaled targets, cached per (ladder, base): a warm
        second run gets the same instances, so a scaled table is made once."""
        return _cached_targets(self, base_target)


@functools.lru_cache(maxsize=64)
def _cached_targets(ladder: Ladder, base_target) -> tuple:
    return tuple(scaled_target(base_target, b) for b in ladder.betas)
