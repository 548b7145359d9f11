"""Measured engine constants: the per-(workload, shape, device) autotuner —
the PyTorch port of ``repro.samplers.autotune``.

``EngineConfig.chunk_steps`` and ``execution`` are hand-chosen constants:
right for the machine they were tuned on, wrong elsewhere.  This module
measures them (a warm-up run, then best-of-N wall clock on a short run,
each ended by a synchronise of the card) and caches the winner per

    (update rule, randomness, target kind, state shape, word type,
     num_chains, collect, device type, device name, device count)

so a given workload shape pays the measurement once per machine.  The
candidate grid always holds the incumbent config first, and the winner
is the measured argmax, so a tuned config is never slower than the
hand-chosen one under the tuner's own protocol.

Chunking and executor choice never change the sample stream (operands
are keyed on absolute steps; scan and the kernels mirror each other op
for op), so tuning may move them between runs, across a checkpoint
boundary too.

``block_c`` is not a knob of the port: the CUDA chain kernel picks its
chain tile itself from B, C and the card's SM count
(``csrc/mh.cu:chain_tile_log``) and ignores ``EngineConfig.block_c``.
So the grid's ``block_c`` axis holds ``config.block_c`` alone and
``block_c_candidates`` is accepted and unused; the result, the cache
entry and the candidate tuples keep the field, so the two packages'
caches have one schema.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` — a file of its own, so neither
package ever takes the other's winner for a cache hit.  Writes are
atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from repro_torch import prng, telemetry
from repro_torch.samplers.engine import (
    EngineConfig,
    MHEngine,
    _wait,
    resolve_device,
    resolve_execution,
)
from repro_torch.samplers.plan import RunPlan

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1

# Small by design: each candidate costs a warm-up and `repeats` runs
DEFAULT_CHUNK_CANDIDATES = (16, 64, 256)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One tuning outcome: the winning constants plus the evidence."""

    chunk_steps: int
    block_c: int
    execution: str
    steps_per_s: float
    # the incumbent (hand-chosen) config measured under the same protocol
    baseline_steps_per_s: float
    source: str  # "measured" | "cache"
    # ((chunk_steps, block_c, execution, steps_per_s), ...) for the report
    candidates: tuple = ()


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _device_parts(device: torch.device) -> tuple[str, str, str]:
    """(device type, device name, device count) of the cache key."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device).replace(" ", "_")
        return "cuda", name, f"D{torch.cuda.device_count()}"
    return device.type, device.type, "D1"


def tune_key(config: EngineConfig, target, init_words, *, device=None) -> str:
    """The cache identity: what the measurement depends on — workload
    kind, state layout, engine axes, device — and nothing it does not
    (the tuned knobs themselves, seeds, step counts).  The word type is
    ``uint32``, the state words' type in both packages (the port holds
    them in int64)."""
    dev = resolve_device(device)
    shape = tuple(torch.as_tensor(init_words).shape)
    parts = (
        config.update,
        config.randomness,
        type(target).__name__,
        "x".join(str(int(s)) for s in shape) or "scalar",
        "uint32",
        f"C{config.num_chains}",
        config.collect,
        *_device_parts(dev),
    )
    return "|".join(parts)


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _store_cache(path: str, cache: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)  # atomic: readers never see a torn file


def _eligible_executions(config: EngineConfig, target, device) -> list[str]:
    """Executors worth measuring: always scan, plus pallas when the
    target and rule can take the kernels.  An explicit
    ``config.execution`` pin narrows the grid to it (the user chose)."""
    if config.execution in ("scan", "pallas"):
        return [config.execution]
    out = ["scan"]
    try:
        resolve_execution("pallas", target, device, config.update)
        out.append("pallas")
    except ValueError:
        pass
    return out


def measure_config(
    config: EngineConfig, target, init_words, *, key=None,
    n_steps: int = 256, repeats: int = 3, device=None,
) -> float:
    """Best-of-N site-steps/s of one candidate config.  The warm-up run
    pays the first build and launch of the kernels; every timed run ends
    in a synchronise of the card before the clock stops, so the time is
    the work's and not its enqueue.  Raises whatever the engine raises on
    an ineligible candidate (``ValueError``) — callers filter."""
    engine = MHEngine(config, device=device)
    plan = RunPlan(
        target=target,
        n_steps=n_steps,
        init_words=init_words,
        key=key if key is not None else prng.PRNGKey(0),
    )
    engine.submit(plan, compiled=True)
    _wait(engine.device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        engine.submit(plan, compiled=True)
        _wait(engine.device)
        best = min(best, time.perf_counter() - t0)
    size = max(1, engine._words(init_words).numel())
    return n_steps * size / max(best, 1e-9)


def autotune_config(
    config: EngineConfig,
    target,
    init_words,
    *,
    key=None,
    n_steps: int = 256,
    repeats: int = 3,
    chunk_candidates=DEFAULT_CHUNK_CANDIDATES,
    block_c_candidates=None,
    cache_path: str | None = None,
    refresh: bool = False,
    device=None,
) -> tuple[EngineConfig, TuneResult]:
    """Tuned ``(config, evidence)`` for this (workload, shape, device) —
    the JAX signature, plus ``device`` (the card unless ``"cpu"`` is
    asked for).

    Cache hit: returns the stored winner without measuring.  Miss (or
    ``refresh=True``): measures the grid — incumbent first, so the argmax
    can never lose to it — stores, and returns.  A candidate the engine
    rejects as ineligible (``ValueError``) is dropped; any other error (a
    kernel that does not build or launch) is raised, and so is the
    incumbent failing: there is no fallback.
    ``block_c_candidates`` is unused (the module docstring says why).
    """
    del block_c_candidates  # the CUDA kernel picks its own chain tile
    dev = resolve_device(device)
    path = cache_path if cache_path is not None else default_cache_path()
    ckey = tune_key(config, target, init_words, device=dev)
    cache = _load_cache(path)
    hit = cache.get(ckey)
    if hit and not refresh and hit.get("version") == CACHE_VERSION:
        tuned = dataclasses.replace(
            config,
            chunk_steps=int(hit["chunk_steps"]),
            block_c=int(hit["block_c"]),
            execution=str(hit["execution"]),
        )
        return tuned, TuneResult(
            chunk_steps=int(hit["chunk_steps"]),
            block_c=int(hit["block_c"]),
            execution=str(hit["execution"]),
            steps_per_s=float(hit["steps_per_s"]),
            baseline_steps_per_s=float(hit["baseline_steps_per_s"]),
            source="cache",
            candidates=tuple(tuple(c) for c in hit.get("candidates", ())),
        )

    incumbent_exec = (
        config.execution
        if config.execution in ("scan", "pallas")
        else resolve_execution(config.execution, target, dev, config.update)
    )
    grid: list[tuple[int, int, str]] = [(config.chunk_steps, config.block_c, incumbent_exec)]
    for execution in _eligible_executions(config, target, dev):
        for chunk in chunk_candidates:
            cand = (int(chunk), config.block_c, execution)
            if cand not in grid:
                grid.append(cand)

    measured: list[tuple[int, int, str, float]] = []
    for i, (chunk, block_c, execution) in enumerate(grid):
        cand_cfg = dataclasses.replace(config, chunk_steps=chunk, execution=execution)
        with telemetry.span(
            "autotune.measure",
            chunk_steps=chunk, block_c=block_c, execution=execution, incumbent=(i == 0),
        ) as sp:
            try:
                rate = measure_config(
                    cand_cfg, target, init_words, key=key, n_steps=n_steps,
                    repeats=repeats, device=dev,
                )
            except ValueError:
                sp.set(outcome="ineligible")
                if i == 0:  # the incumbent must run — no fallback
                    raise
                continue
            sp.set(outcome="ok", steps_per_s=round(rate, 1))
        measured.append((chunk, block_c, execution, rate))

    baseline_rate = measured[0][3]
    chunk, block_c, execution, rate = max(measured, key=lambda m: m[3])
    telemetry.log(
        "autotune.result",
        chunk_steps=chunk, block_c=block_c, execution=execution,
        steps_per_s=round(rate, 1),
        baseline_steps_per_s=round(baseline_rate, 1),
        candidates=len(measured),
    )
    result = TuneResult(
        chunk_steps=chunk,
        block_c=block_c,
        execution=execution,
        steps_per_s=rate,
        baseline_steps_per_s=baseline_rate,
        source="measured",
        candidates=tuple(measured),
    )
    cache[ckey] = {
        "version": CACHE_VERSION,
        "chunk_steps": chunk,
        "block_c": block_c,
        "execution": execution,
        "steps_per_s": rate,
        "baseline_steps_per_s": baseline_rate,
        "candidates": [list(m) for m in measured],
    }
    _store_cache(path, cache)
    tuned = dataclasses.replace(config, chunk_steps=chunk, execution=execution)
    return tuned, result


def autotune_engine(engine: MHEngine, target, init_words, **kwargs) -> tuple[MHEngine, TuneResult]:
    """``autotune_config`` for an existing engine, on its device: returns
    a fresh engine on the tuned config."""
    tuned_cfg, result = autotune_config(
        engine.config, target, init_words, device=engine.device, **kwargs
    )
    return MHEngine(tuned_cfg, device=engine.device), result
