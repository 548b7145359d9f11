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

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1p5b --smoke \\
      --steps 50 --batch 8 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
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
    model and the optimizer state; returns the optimizer state."""
    named = dict(model.named_parameters())
    for name, value in tree_to_named(tree["params"], named).items():
        named[name].copy_(value)
    opt_state["step"] = tree["opt"]["step"].to(device=opt_state["step"].device,
                                                  dtype=torch.int32)
    for part in ("m", "v", "master"):
        if part in opt_state:
            for name, value in tree_to_named(tree["opt"][part], named).items():
                opt_state[part][name].copy_(value)
    return opt_state


def run_training(run: TrainRun, preemption: PreemptionHandler | None = None, model=None):
    """Train ``run.steps`` steps (or resume from ``run.ckpt_dir``); returns
    (model, opt_state, losses).  ``model`` is the ``lm.LM`` to train (on
    the run's device), else one drawn from ``run.seed``."""
    cfg = run.cfg
    device = resolve_device(run.device)
    if model is None:
        model = lm.init_lm(cfg, run.seed, device)
    opt_cfg = AdamWConfig(lr=run.lr)
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

    def schedule(s):
        return cosine_schedule(s, run.warmup, run.steps)

    step_fn = make_train_step(
        cfg,
        None,
        opt_cfg,
        schedule_fn=schedule,
        step_cfg=TrainStepConfig(n_micro=run.n_micro),
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

    losses = []
    for step in range(start_step, run.steps):
        batch = data.host_batch(step)
        t0 = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
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
