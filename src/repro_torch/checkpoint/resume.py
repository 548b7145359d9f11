"""Bit-exact resumable runs: the checkpoint-backed segment driver — the
port of ``repro.checkpoint.resume``.

``run_resumable`` runs a ``RunPlan`` as a sequence of checkpointed
segments.  After each segment it copies the engine's resume carry
``(words, logp, accept_count)`` and the accumulated sample stream to the
host and saves them (checkpoint.py, the JAX package's format and
dtypes); the next call on the same ``directory`` restores the newest
checkpoint and continues.  The result equals one unsegmented submit word
for word:

  * operands for step ``t`` depend only on ``(key, step0 + t)``, so a
    restarted segment continues the exact randomness stream;
  * ``accept_count`` sums exactly (int32 per-site counts), and
    ``acceptance_rate`` is the engine's own float32 expression over the
    sum;
  * ``final_logp`` rides the solo MH scan carry or is re-derived from the
    restored state by a deterministic ``log_prob``;
  * ``thin:<k>`` keeps *absolute* steps, so per-segment kept sets
    concatenate into the unsegmented kept set.

A checkpoint records the plan's fingerprint (engine axes, stream key,
state layout; not chunk_steps/block_c/execution) and a restore refuses a
mismatch: a resumed run is the same chain or an error.  ``on_segment``
is a post-save hook — raising from it is how tests simulate preemption.
A directory that either package left is finished by either.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint.checkpoint import (
    checkpoint_nbytes,
    latest_step,
    load_checkpoint_tree,
    run_state,
    save_checkpoint,
    words_from_host,
)
from repro_torch.samplers.engine import (
    EngineResult,
    MHEngine,
    _acceptance_rate,
    parse_collect,
)
from repro_torch.samplers.plan import (
    RunHandle,
    RunPlan,
    carries_logp,
    fingerprint_digest,
)


def _time_axis(engine: MHEngine) -> int:
    """Axis of the kept-step dimension in ``EngineResult.samples``:
    multi-chain runs are chain-major (C, T, *state), solo runs (T, *state)
    — segment streams concatenate along it."""
    return 1 if engine.config.num_chains > 1 else 0


def _empty_samples(words, axis: int) -> tuple:
    """The engine's ``collect='last'`` placeholder shape: a 0-length time
    axis in the chain-major layout."""
    shape = list(np.shape(words))
    shape.insert(axis, 0)
    return tuple(shape)


def _assemble(plan, engine, acc, samples_pieces, words, logp, mode, axis) -> EngineResult:
    """The stitched EngineResult on the engine's device, with the
    engine's own output dtypes and rate expression."""
    device = engine.device
    if mode == "last":
        samples = np.zeros(_empty_samples(words, axis), np.uint32)
    elif len(samples_pieces) == 1:
        samples = samples_pieces[0]
    else:
        samples = np.concatenate(samples_pieces, axis=axis)
    acc = torch.from_numpy(np.asarray(acc, np.int32)).to(device)
    return EngineResult(
        samples=words_from_host(samples, device),
        accept_count=acc,
        acceptance_rate=_acceptance_rate(acc, int(plan.n_steps)),
        final_words=(
            words.to(device) if isinstance(words, torch.Tensor) else words_from_host(words, device)
        ),
        final_logp=torch.as_tensor(logp).to(device=device, dtype=torch.float32),
        n_steps=int(plan.n_steps),
    )


def run_resumable(
    engine: MHEngine,
    plan: RunPlan,
    *,
    directory: str,
    every: int | None = None,
    on_segment=None,
    verify: bool = True,
) -> RunHandle:
    """Run ``plan`` in checkpointed segments of ``every`` steps (default:
    the engine's ``chunk_steps``); restart from the newest checkpoint in
    ``directory`` when one exists.

    Returns a ``RunHandle`` whose result equals ``engine.submit(plan)``
    run unsegmented, however many times the process died in between.
    ``on_segment(done, total, handle)`` fires after each segment's
    checkpoint commits; raising from it abandons the run after the save.
    Each segment costs one copy of its carry and kept rows to the host
    and one checkpoint write; the chain state stays on the card between
    segments.
    """
    n_total = int(plan.n_steps)
    base = int(plan.step0)
    every = int(every) if every else engine.config.chunk_steps
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    mode, _k = parse_collect(plan.collect if plan.collect is not None else engine.config.collect)
    axis = _time_axis(engine)
    fingerprint = plan.fingerprint(engine)
    fp = fingerprint_digest(fingerprint)

    # -- restore ------------------------------------------------------------
    done = 0
    acc = np.zeros(tuple(np.shape(plan.init_words)), np.int32)
    pieces: list = []
    words = plan.init_words
    logp = None
    step = latest_step(directory)
    if step is not None:
        tree, manifest = load_checkpoint_tree(directory, step, verify=verify)
        saved_fp = manifest.get("extra", {}).get("fingerprint")
        if saved_fp != fingerprint:
            raise ValueError(
                f"checkpoint {directory} step {step} was written by a "
                "different run (engine axes / stream key / state layout "
                "differ) — refusing to resume a different chain; "
                f"saved fingerprint {saved_fp!r} != plan {fingerprint!r}"
            )
        done = step - base
        if not 0 < done <= n_total:
            raise ValueError(
                f"checkpoint step {step} is outside this plan's span "
                f"[{base}, {base + n_total}] — wrong directory?"
            )
        acc = tree["acc"]
        words = tree["words"]
        logp = tree["logp"]
        if mode != "last":
            pieces = [tree["samples"]]
        telemetry.log(
            "run_resumable.restore",
            fingerprint=fp, step=int(step), done=int(done),
            total=n_total, directory=directory,
        )

    handle = None
    segment = 0
    while done < n_total:
        seg = min(every, n_total - done)
        if handle is None:
            sub = plan.replace(
                n_steps=seg,
                step0=base + done,
                init_words=words,
                # a fresh run's first segment keeps the plan's own carry; a
                # restored one re-seeds it from the checkpoint when the
                # engine takes the carry at all
                init_logp=(
                    torch.from_numpy(np.asarray(logp, np.float32))
                    if done and carries_logp(engine, plan.target)
                    else (plan.init_logp if done == 0 else None)
                ),
            )
            handle = engine.submit(sub)
        else:
            handle = handle.resume(seg)
        state = run_state(
            words=handle.final_words, logp=handle.final_logp, acc=handle.accept_count,
            samples=handle.samples if mode != "last" else None,
        )
        acc = acc + state["acc"]
        if mode != "last":
            pieces.append(state["samples"])
        words = handle.final_words
        logp = state["logp"]
        done += seg
        ckpt_path = save_checkpoint(
            directory,
            base + done,
            {
                "acc": np.asarray(acc, np.int32),
                "logp": logp,
                "samples": (
                    (np.concatenate(pieces, axis=axis) if len(pieces) > 1 else pieces[0])
                    if mode != "last"
                    else np.zeros(_empty_samples(words, axis), np.uint32)
                ),
                "words": state["words"],
            },
            extra={
                "fingerprint": fingerprint,
                "base_step": base,
                "total_steps": n_total,
            },
        )
        telemetry.log(
            "run_resumable.segment",
            fingerprint=fp, segment=segment, step=base + done,
            done=done, total=n_total, bytes=checkpoint_nbytes(ckpt_path),
        )
        telemetry.counter("resume_segments_total", "checkpointed segments committed").inc()
        segment += 1
        if len(pieces) > 1:  # keep the accumulated stream as one block
            pieces = [np.concatenate(pieces, axis=axis)]
        if on_segment is not None:
            on_segment(done, n_total, handle)

    result = _assemble(plan, engine, acc, pieces, words, logp, mode, axis)
    return RunHandle(plan=plan, result=result, engine=engine)
