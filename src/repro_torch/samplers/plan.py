"""The run surface: ``RunPlan`` in, ``RunHandle`` out — the PyTorch port
of ``repro.samplers.plan``.

A ``RunPlan`` is one validated run spec: what to sample (``target``,
``n_steps``, ``collect``), which stream (``key`` or ``seed``,
``chain_id``) and the resume carry (``step0``, ``init_words``,
``init_logp``).  ``MHEngine.submit(plan)`` runs it and returns a
``RunHandle``, whose ``resume(n)`` continues the exact stream of one
unsegmented run and whose ``save(directory)`` checkpoints that carry
(``repro_torch.checkpoint``, the JAX package's on-disk format).  ``mesh``
shards the chain axis (``samplers/engine.py``).  ``submit(plan,
compiled=True)`` is the JAX package's one-dispatch compiled entry: on the
card the whole run is captured as a CUDA graph once per signature and
replayed after that.  With telemetry on, every submit runs under an
``engine.submit`` span that times the host's side of the call.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import compiled, prng, telemetry
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
    ``step0``/``init_logp`` are the resume carry; ``step0`` is an int or
    a 0-d int64 tensor on the engine's device (JAX's traced offset), which
    nothing here reads on the host, so a submit at a step held on the
    card can be captured.  ``mesh`` (a 1-D ``DeviceMesh``) shards the
    chain axis of a multi-chain run.
    """

    target: Any
    n_steps: int
    init_words: Any
    key: Any = None
    seed: int | None = None
    chain_id: int = 0
    step0: Any = 0
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
        if _is_concrete_int(self.step0) and int(self.step0) < 0:
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

    @property
    def concrete_step0(self) -> int:
        """``step0`` as a Python int; a tensor ``step0`` raises, since
        reading it would wait for the card."""
        if not _is_concrete_int(self.step0):
            raise ValueError(
                "this plan carries a tensor step0 — only plans with host-int "
                "offsets have a Python-level progress"
            )
        return int(self.step0)

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
        """Absolute step after this segment (= the next plan's step0);
        raises for a tensor ``step0`` (``RunPlan.concrete_step0``)."""
        return self.plan.concrete_step0 + int(self.plan.n_steps)

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


# --- the one-dispatch compiled entry ---------------------------------------
#
# The JAX package jits ``engine.run`` with ``engine``, ``target``,
# ``n_steps``, ``chain_id``, ``step0``, ``collect`` and ``mesh`` static (the
# engine, target and mesh by identity) and traces anew on a new shape.  On
# the card the counterpart of one such program is a CUDA graph
# (``repro_torch.compiled``): the whole ``engine.run`` of one signature, its
# chunk loop and every kernel in it, captured once and then replayed by one
# graph launch.  The programs live on their engine (``MHEngine._compiled``)
# and die with it; each holds its target and mesh, whose tensors' addresses
# a graph bakes in, so that an ``id`` Python reuses can never find it.  On
# the CPU there is no graph: the cache keeps the signatures only, so the
# ``jit_cache`` verdicts are the card's.


class Signature(NamedTuple):
    """What one compiled program is specialised on: JAX's statics (the
    target and mesh by identity) and the (shape, dtype) of each input as
    the engine takes it, None where it is absent."""

    target: int
    mesh: int | None
    n_steps: int
    chain_id: int
    step0: int
    collect: str | None
    key: tuple
    init_words: tuple
    init_logp: tuple | None


def _is_concrete_int(x) -> bool:
    """A host int: a tensor ``step0`` takes the direct path, as a traced
    one does in the JAX package."""
    return isinstance(x, (int, np.integer))


def _run(engine: MHEngine, plan: RunPlan, key, init_words, init_logp) -> EngineResult:
    return engine.run(
        key, plan.target, plan.n_steps, init_words, chain_id=plan.chain_id,
        mesh=plan.mesh, step0=plan.step0, collect=plan.collect, init_logp=init_logp,
    )


def _inputs(plan: RunPlan) -> tuple:
    """The key, init words and init log-probs as the engine takes them: a
    tensor as it was given, anything else as a CPU tensor made here."""
    key = plan.key if isinstance(plan.key, torch.Tensor) else plan.resolved_key("cpu")
    words = plan.init_words
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.asarray(words).astype(np.int64))
    logp = plan.init_logp
    if logp is not None and not isinstance(logp, torch.Tensor):
        logp = torch.from_numpy(np.asarray(logp))
    return key, words, logp


def _signature(plan: RunPlan, inputs: tuple) -> Signature:
    key, words, logp = (compiled.layout(x) for x in inputs)
    return Signature(
        target=id(plan.target), mesh=None if plan.mesh is None else id(plan.mesh),
        n_steps=int(plan.n_steps), chain_id=int(plan.chain_id), step0=int(plan.step0),
        collect=plan.collect, key=key, init_words=words, init_logp=logp,
    )


def _submit_compiled(engine: MHEngine, plan: RunPlan) -> tuple[EngineResult, str]:
    """The compiled entry: (result, ``"miss"`` when this submit captured,
    ``"hit"`` when it reused a program).  A failed capture or replay
    raises ``RuntimeError`` naming the signature: a card never runs a
    compiled submit eagerly in its place."""
    inputs = _inputs(plan)
    sig = _signature(plan, inputs)
    return compiled.call(
        engine._compiled, sig, functools.partial(_run, engine, plan), inputs, engine.device,
        f"compiled submit {sig}", holds=(plan.target, plan.mesh), name="engine.run",
    )


def _submit_span(engine: MHEngine, plan: RunPlan, compiled: bool):
    """The ``engine.submit`` telemetry span, with the JAX span's metadata;
    a compiled submit adds ``jit_cache``.  It times the host's side of the
    submit: kernels are queued, not waited for (a miss waits, as a JAX
    compile does)."""
    cfg = engine.config
    return telemetry.span(
        "engine.submit",
        update=cfg.update,
        randomness=cfg.randomness,
        execution=cfg.execution,
        n_steps=int(plan.n_steps),
        step0=int(plan.step0) if _is_concrete_int(plan.step0) else None,
        collect=plan.collect if plan.collect is not None else cfg.collect,
        num_chains=cfg.num_chains,
        compiled=compiled,
    )


def submit(engine: MHEngine, plan: RunPlan, *, compiled: bool = False) -> RunHandle:
    """Run ``plan`` on ``engine``; the function behind ``MHEngine.submit``.

    ``compiled=True`` routes through the cached compiled entry above (one
    graph launch a submit once its signature is captured; on the CPU the
    direct path).  A tensor ``step0`` always takes the direct path, as a
    traced offset does in the JAX package.  With telemetry on the call
    runs under an ``engine.submit`` span whose ``jit_cache`` records, on
    the compiled path, whether this submit captured (``"miss"``) or
    replayed (``"hit"``); the sampled stream is the same with telemetry on
    or off.
    """
    if not isinstance(plan, RunPlan):
        raise TypeError(
            f"submit takes a RunPlan, got {type(plan).__name__} — build one "
            "with samplers.RunPlan(target=..., n_steps=..., init_words=..., "
            "seed=...)"
        )
    with _submit_span(engine, plan, compiled) as span:  # a shared no-op while telemetry is off
        if compiled and _is_concrete_int(plan.step0):
            result, verdict = _submit_compiled(engine, plan)
            span.set(jit_cache=verdict)
        else:
            result = _run(
                engine, plan, plan.resolved_key(engine.device), plan.init_words,
                plan.init_logp,
            )
    return RunHandle(plan=plan, result=result, engine=engine)
