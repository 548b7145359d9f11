"""The run surface: ``RunPlan`` in, ``RunHandle`` out — the PyTorch port
of ``repro.samplers.plan``.

A ``RunPlan`` is one validated run spec: what to sample (``target``,
``n_steps``, ``collect``), which stream (``key`` or ``seed``,
``chain_id``) and the resume carry (``step0``, ``init_words``,
``init_logp``).  ``MHEngine.submit(plan)`` runs it and returns a
``RunHandle``, whose ``resume(n)`` continues the exact stream of one
unsegmented run and whose ``save(directory)`` checkpoints that carry
(``repro_torch.checkpoint``, the JAX package's on-disk format).  ``mesh``
shards the chain axis (``samplers/engine.py``).  With telemetry on, every
submit runs under an ``engine.submit`` span that times the host's side
of the call: the span never waits for the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np
import torch

from repro_torch import prng, telemetry
from repro_torch.samplers.engine import (
    EngineResult,
    MHEngine,
    parse_collect,
    resolve_execution,
)


def fingerprint_digest(fingerprint: dict) -> str:
    """A short stable identity of a :meth:`RunPlan.fingerprint` dict —
    what the telemetry log lines print, so a checkpoint can be matched to
    its run without the whole key."""
    blob = json.dumps(fingerprint, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def carries_logp(engine: MHEngine, target) -> bool:
    """Whether ``engine`` takes a segment's ``final_logp`` as the next
    segment's ``init_logp`` (the solo MH scan carry).  Elsewhere resume
    re-derives the log-prob from the state, which is bit-identical; a
    Gibbs resume re-derives everything, the checkerboard parity included,
    from ``(final_words, step0)``."""
    cfg = engine.config
    if cfg.update != "mh" or cfg.num_chains != 1:
        return False
    try:
        return resolve_execution(cfg.execution, target, engine.device) == "scan"
    except ValueError:
        return False


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """One validated run spec.

    ``key`` and ``seed`` are mutually exclusive: a key tensor of shape
    (2,), or an int seed resolved to ``prng.PRNGKey(seed)`` on the
    engine's device at submit time.  ``init_words`` is required.
    ``step0``/``init_logp`` are the resume carry.  ``mesh`` (a 1-D
    ``DeviceMesh``) shards the chain axis of a multi-chain run.
    """

    target: Any
    n_steps: int
    init_words: Any
    key: Any = None
    seed: int | None = None
    chain_id: int = 0
    step0: int = 0
    collect: str | None = None
    mesh: Any = None
    init_logp: Any = None

    def __post_init__(self):
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if (self.key is None) == (self.seed is None):
            raise ValueError(
                "a RunPlan names its randomness stream with exactly one of "
                "key= (a PRNG key) or seed= (an int resolved to "
                f"prng.PRNGKey at submit); got key={self.key!r}, "
                f"seed={self.seed!r}"
            )
        if self.init_words is None:
            raise ValueError(
                "init_words is required — the engine never guesses chain state"
            )
        if int(self.step0) < 0:
            raise ValueError(f"step0 must be >= 0, got {self.step0}")
        if self.collect is not None:
            parse_collect(self.collect)

    def replace(self, **updates) -> "RunPlan":
        """A re-validated copy with ``updates`` applied."""
        return dataclasses.replace(self, **updates)

    def resolved_key(self, device=None) -> torch.Tensor:
        """The key this plan streams from, on ``device``."""
        if self.key is not None:
            return torch.as_tensor(self.key).to(device=device, dtype=torch.int64)
        return prng.PRNGKey(self.seed, device=device)

    def fingerprint(self, engine: MHEngine) -> dict:
        """A JSON-able identity of (engine axes, stream, state layout):
        what must match for a checkpointed resume to continue the same
        chain — the JAX package's dict for the same plan.  Leaves out
        ``chunk_steps``/``block_c``/``execution``, which never change the
        stream."""
        cfg = engine.config
        key = self.resolved_key("cpu")
        return {
            "update": cfg.update,
            "randomness": cfg.randomness,
            "p_bfr": cfg.p_bfr,
            "rng_p_bfr": cfg.rng_p_bfr,
            "rng_bit_width": cfg.rng_bit_width,
            "rng_stages": cfg.rng_stages,
            "num_chains": cfg.num_chains,
            "chain_id": int(self.chain_id),
            "collect": self.collect if self.collect is not None else cfg.collect,
            "key": [int(w) & 0xFFFFFFFF for w in key.reshape(-1).tolist()],
            "target": type(self.target).__name__,
            "state_shape": [int(s) for s in np.shape(self.init_words)],
        }


@dataclasses.dataclass
class RunHandle:
    """A finished (segment of a) run: the result, the plan that produced
    it and the engine it ran on.  ``resume(n)`` continues the stream:
    segment streams concatenate to one unsegmented run bit for bit."""

    plan: RunPlan
    result: EngineResult
    engine: MHEngine

    @property
    def samples(self):
        return self.result.samples

    @property
    def accept_count(self):
        return self.result.accept_count

    @property
    def acceptance_rate(self):
        return self.result.acceptance_rate

    @property
    def final_words(self):
        return self.result.final_words

    @property
    def final_logp(self):
        return self.result.final_logp

    @property
    def n_steps(self):
        return self.result.n_steps

    @property
    def progress(self) -> int:
        """Absolute step after this segment (= the next plan's step0)."""
        return int(self.plan.step0) + int(self.plan.n_steps)

    def resume_plan(self, n_steps: int, **overrides) -> RunPlan:
        """The continuation plan for ``n_steps`` more steps."""
        updates = dict(
            n_steps=n_steps,
            step0=self.progress,
            init_words=self.final_words,
            init_logp=(
                self.final_logp
                if carries_logp(self.engine, self.plan.target) else None
            ),
        )
        updates.update(overrides)
        return self.plan.replace(**updates)

    def resume(self, n_steps: int, **overrides) -> "RunHandle":
        """Run ``n_steps`` more on the same engine."""
        return self.engine.submit(self.resume_plan(n_steps, **overrides))

    def save(self, directory: str) -> str:
        """Checkpoint the resume carry (words/logp/accept) at this
        handle's absolute step through ``repro_torch.checkpoint``, in the
        JAX package's format and dtypes, with the plan's fingerprint; logs
        a ``run_handle.save`` line.  Returns the checkpoint's path."""
        from repro_torch.checkpoint import run_state, save_checkpoint  # checkpoint imports us

        fingerprint = self.plan.fingerprint(self.engine)
        with telemetry.span("checkpoint.handle_save", step=self.progress):
            path = save_checkpoint(
                directory,
                self.progress,
                run_state(
                    words=self.final_words, logp=self.final_logp,
                    acc=self.accept_count,
                ),
                extra={"fingerprint": fingerprint},
            )
        telemetry.log(
            "run_handle.save",
            fingerprint=fingerprint_digest(fingerprint),
            step=self.progress,
            n_steps=int(self.plan.n_steps),
            path=path,
        )
        return path


def _submit_span(engine: MHEngine, plan: RunPlan, compiled: bool):
    """The ``engine.submit`` telemetry span, with the JAX span's metadata
    (no ``jit_cache``: the port has no jitted dispatcher).  It times the
    host's side of the submit: kernels are queued, not waited for."""
    cfg = engine.config
    return telemetry.span(
        "engine.submit",
        update=cfg.update,
        randomness=cfg.randomness,
        execution=cfg.execution,
        n_steps=int(plan.n_steps),
        step0=int(plan.step0),
        collect=plan.collect if plan.collect is not None else cfg.collect,
        num_chains=cfg.num_chains,
        compiled=compiled,
    )


def submit(engine: MHEngine, plan: RunPlan, *, compiled: bool = False) -> RunHandle:
    """Run ``plan`` on ``engine``; the function behind ``MHEngine.submit``.

    PyTorch runs eagerly and has no counterpart of the JAX package's
    jitted dispatcher, so ``compiled=True`` runs the same path as the
    default and is accepted for the JAX signature.  With telemetry on the
    call runs under an ``engine.submit`` span; the sampled stream is the
    same with telemetry on or off.
    """
    if not isinstance(plan, RunPlan):
        raise TypeError(
            f"submit takes a RunPlan, got {type(plan).__name__} — build one "
            "with samplers.RunPlan(target=..., n_steps=..., init_words=..., "
            "seed=...)"
        )
    with _submit_span(engine, plan, compiled):  # a shared no-op while telemetry is off
        result = engine.run(
            plan.resolved_key(engine.device), plan.target, plan.n_steps,
            plan.init_words, chain_id=plan.chain_id, mesh=plan.mesh,
            step0=plan.step0, collect=plan.collect, init_logp=plan.init_logp,
        )
    return RunHandle(plan=plan, result=result, engine=engine)
