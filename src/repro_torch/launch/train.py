"""Training entry point: data -> train step -> checkpoint, with fault
tolerance — the port of ``repro.launch.train``.

Fault tolerance in the loop, as in the JAX launcher:
  * auto-resume from the latest valid checkpoint,
  * SIGTERM/SIGINT -> checkpoint at the next step boundary, exit 0,
  * periodic + final checkpoints (atomic, integrity-hashed, retained K),
  * per-step wall-time watchdog feeding the straggler detector (one host
    here: flags log),
  * deterministic (seed, step) data — restart replays identical batches.

The run state ``{"params", "opt"}`` is saved in the JAX package's on-disk
format and tree layout (``convert.named_to_tree``: the block leaves
stacked on a layer axis; ``opt`` holds ``step``, ``m``, ``v``), so either
package can read the other's checkpoint.  The weights are drawn from a
``torch.Generator`` seeded with ``--seed`` (``models/layers.py``), not
JAX's: ``run_training(run, model=...)`` trains given weights (for
example JAX's, carried by ``convert.lm_from_numpy``).  The run is on the
card unless ``--device cpu`` is asked for; without a card it raises.

The step is the port of JAX's ``jax.jit(make_train_step(...))``: one
compiled program (``repro_torch.compiled``) a ``TrainSignature``, the
batch's layouts and ``n_micro``.  On the card a signature's first step
runs once (its result) and is captured as a CUDA graph; later steps copy
the batch into the program's buffers and replay it, one graph launch a
step.  The graph reads and writes the model's parameters and the AdamW
state in their own tensors (``adamw_update`` and ``load_state`` write
them in place), and only the metrics come out of it, cloned.  A failed
capture or replay raises ``RuntimeError`` naming the signature; no eager
step runs in its place.  On the CPU the step runs directly and the cache
keeps the signatures, as many as JAX's jit keeps programs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1p5b --smoke \\
      --steps 50 --batch 8 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import operator
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import compiled, configs
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.convert import named_to_tree, tree_to_named
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.distributed.fault import PreemptionHandler
from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.samplers.engine import _wait, resolve_device
from repro_torch.training.step import TrainStepConfig, make_train_step


@dataclasses.dataclass
class TrainRun:
    cfg: object
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    n_micro: int = 1
    log_every: int = 10
    device: str | None = None        # the card unless "cpu" is asked for


class TrainSignature(NamedTuple):
    """What a train program is compiled for, as JAX's jit keys ``step_fn``
    on its inputs' layouts: ``compiled.layout`` of each batch input (None
    where the family has none) and the microbatch count."""

    tokens: tuple | None
    labels: tuple | None
    image_embeds: tuple | None
    frames: tuple | None
    n_micro: int


BATCH_KEYS = ("tokens", "labels", "image_embeds", "frames")
# what a step returns, the metrics a program clones out of its graph
METRICS = ("loss", "ce_loss", "aux_loss", "tokens", "grad_norm", "lr")


def state_tensors(model, opt_state) -> list:
    """The tensors a step reads and writes in place: the parameters, the
    step counter, and the moments (and master copies)."""
    out = [*model.parameters(), opt_state["step"]]
    for part in ("m", "v", "master"):
        out.extend(opt_state.get(part, {}).values())
    return out


def compiled_step(programs: dict, step_fn, model, opt_state, batch: dict, n_micro: int,
                  device) -> dict:
    """``step_fn(model, opt_state, batch)`` (an unmeshed ``make_train_step``
    with ``n_micro`` microbatches) through the program of the batch's
    ``TrainSignature`` in ``programs``; returns the metrics ``METRICS``.
    The model and ``opt_state`` are trained in place.  On the card a
    program bakes in the addresses of ``state_tensors``: a step after one
    of them was replaced raises ``RuntimeError``."""
    unknown = set(batch) - set(BATCH_KEYS)
    if unknown:
        raise ValueError(f"a train batch holds no {sorted(unknown)}")
    inputs = tuple(batch.get(k) for k in BATCH_KEYS)
    sig = TrainSignature(*map(compiled.layout, inputs), n_micro=n_micro)
    tensors = state_tensors(model, opt_state)
    held = programs.get(sig)
    if held is not None and held.graph is not None and not (
            held.holds[0] is model and len(held.holds[1]) == len(tensors)
            and all(map(operator.is_, held.holds[1], tensors))):
        raise RuntimeError(
            f"train step {sig}: the model's parameters or the optimizer state were replaced "
            "after the capture; the program reads and writes the ones it captured")

    def run(*staged):
        _, _, metrics = step_fn(model, opt_state, {
            k: x for k, x in zip(BATCH_KEYS, staged) if x is not None})
        return tuple(metrics[k] for k in METRICS)

    values, _ = compiled.call(programs, sig, run, inputs, device, f"train step {sig}",
                              holds=(model, tensors), name="the train step")
    return dict(zip(METRICS, values))


def _host_stack(values) -> torch.Tensor:
    return torch.stack([v.detach().cpu() for v in values])


def state_tree(model, opt_state, stack=_host_stack) -> dict:
    """The run state in the JAX package's layout: ``{"params": <value
    tree>, "opt": {"step", "m", "v"[, "master"]}}``, stacked on the host."""
    opt = {"step": opt_state["step"]}
    for part in ("m", "v", "master"):
        if part in opt_state:
            opt[part] = named_to_tree(opt_state[part], stack)
    return {"params": named_to_tree(dict(model.named_parameters()), stack), "opt": opt}


@torch.no_grad()
def load_state(model, opt_state, tree) -> dict:
    """Write a restored run state (host tensors in the JAX layout) into the
    model's and the optimizer state's own tensors; returns the optimizer
    state."""
    named = dict(model.named_parameters())
    for name, value in tree_to_named(tree["params"], named).items():
        named[name].copy_(value)
    opt_state["step"].copy_(tree["opt"]["step"])  # in place: a program holds it
    for part in ("m", "v", "master"):
        if part in opt_state:
            for name, value in tree_to_named(tree["opt"][part], named).items():
                opt_state[part][name].copy_(value)
    return opt_state


def run_step_fn(run: TrainRun):
    """(the AdamW config, the unmeshed step function) ``run_training``
    trains ``run`` with: AdamW at ``run.lr`` under the cosine schedule of
    ``run.warmup`` and ``run.steps``, ``run.n_micro`` microbatches."""
    opt_cfg = AdamWConfig(lr=run.lr)

    def schedule(s):
        return cosine_schedule(s, run.warmup, run.steps)

    return opt_cfg, make_train_step(run.cfg, None, opt_cfg, schedule_fn=schedule,
                                    step_cfg=TrainStepConfig(n_micro=run.n_micro))


def run_training(run: TrainRun, preemption: PreemptionHandler | None = None, model=None):
    """Train ``run.steps`` steps (or resume from ``run.ckpt_dir``); returns
    (model, opt_state, losses).  ``model`` is the ``lm.LM`` to train (on
    the run's device), else one drawn from ``run.seed``."""
    cfg = run.cfg
    device = resolve_device(run.device)
    if model is None:
        model = lm.init_lm(cfg, run.seed, device)
    opt_cfg, step_fn = run_step_fn(run)
    opt_state = adamw_init(model, opt_cfg)

    data = SyntheticTokenPipeline(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=run.seq_len,
            global_batch=run.global_batch,
            seed=run.seed,
        ),
        device=device,
    )

    manager = None
    start_step = 0
    if run.ckpt_dir:
        manager = CheckpointManager(
            CheckpointConfig(directory=run.ckpt_dir, retention=3)
        )
        like = state_tree(model, opt_state,
                          stack=lambda vs: torch.empty((len(vs), *vs[0].shape), device="meta"))
        restored, ck_step = manager.restore_latest(like, device="cpu")
        if restored is not None:
            opt_state = load_state(model, opt_state, restored)
            start_step = ck_step
            print(f"[train] resumed from step {start_step}")

    watchdog = StragglerWatchdog(
        n_hosts=1,
        on_flag=lambda h, ema, med: print(
            f"[train] WARN host {h} straggling: {ema:.3f}s vs median {med:.3f}s"
        ),
    )

    programs: dict = {}  # TrainSignature -> compiled.Program, JAX's jit cache
    losses = []
    for step in range(start_step, run.steps):
        batch = data.host_batch(step)
        t0 = time.time()
        metrics = compiled_step(programs, step_fn, model, opt_state, batch, run.n_micro, device)
        loss = float(metrics["loss"])
        watchdog.record(0, time.time() - t0)
        watchdog.check()
        losses.append(loss)
        if step % run.log_every == 0 or step == run.steps - 1:
            print(
                f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr x{float(metrics['lr']):.2e} ({time.time() - t0:.2f}s)"
            )
        if manager and (step + 1) % run.ckpt_every == 0:
            manager.save(step + 1, state_tree(model, opt_state))
        if preemption is not None and preemption.preemption_requested:
            print(f"[train] preemption requested — checkpointing at step {step + 1}")
            if manager:
                manager.save(step + 1, state_tree(model, opt_state))
                manager.wait()
            return model, opt_state, losses
    if manager:
        manager.save(run.steps, state_tree(model, opt_state))
        manager.wait()
    _wait(device)
    return model, opt_state, losses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="Train one architecture on synthetic tokens (PyTorch port).",
    )
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the run goes: the card (default; raises without one) or the CPU",
    )
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the arguments say; prints the JAX launcher's ``[train]``
    lines and returns ``{"losses", "model", "opt_state"}``."""
    args = parse_args(argv)
    cfg = (
        configs.get_smoke_config(args.arch)
        if args.smoke
        else configs.get_config(args.arch)
    )
    handler = PreemptionHandler().install()
    run = TrainRun(
        cfg=cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        n_micro=args.n_micro,
        ckpt_dir=args.ckpt_dir,
        seed=args.seed,
        device=args.device,
    )
    try:
        model, opt_state, losses = run_training(run, preemption=handler)
    finally:
        handler.uninstall()
    n = max(1, len(losses) // 10)
    print(
        f"[train] done: first-{n} mean loss {np.mean(losses[:n]):.4f} -> "
        f"last-{n} mean loss {np.mean(losses[-n:]):.4f}"
    )
    return {"losses": losses, "model": model, "opt_state": opt_state}


if __name__ == "__main__":
    main()
