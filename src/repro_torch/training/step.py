"""Step factories: train (gradient accumulation) and serve — the port of
``repro.training.step``.

``make_train_step`` builds the update the launcher runs:

    (model, opt_state, batch) -> (model, opt_state', metrics)

* **Microbatching / gradient accumulation**: the global batch splits into
  ``n_micro`` sequential microbatches, each differentiated with
  ``torch.autograd.grad`` and added into float32 buffers as ``g /
  n_micro`` (never ``.grad``, which would add in the parameters'
  bfloat16); with one microbatch the gradients keep the parameters'
  dtype, as ``jax.value_and_grad`` gives them.
* The model's parameters are trained in place: the step turns their
  gradients on and ``adamw_update`` writes them.

The compressed cross-pod data parallelism (``compress_pods``) and the
ZeRO sharding of the moments come with the distributed slice (ROADMAP.md
queue 1 item 10g) and raise here.

Serving: ``make_prefill_step`` / ``make_decode_step`` close over the
config; ``make_decode_sample_step`` fuses the paper's CIM-MCMC token
sampler into the decode step (on the card its chain is the MH operand
kernel, ``csrc/mh.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import token_sampler
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1
    compress_pods: bool = False
    pod_axis: str = "pod"


def _accumulated_grads(loss_fn, model, batch, n_micro: int):
    """Mean loss, metrics and gradients (``{name: tensor}``) over
    ``n_micro`` sequential microbatches."""
    named = dict(model.named_parameters())
    params = list(named.values())
    if n_micro <= 1:
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))

    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"a batch of {rows} rows does not split into {n_micro} microbatches")
    size = rows // n_micro
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    dev = params[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in ("ce_loss", "aux_loss", "tokens")}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, metrics = loss_fn(model, mb)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for a, g in zip(g_acc.values(), grads):
                a.add_(g.float() / n_micro)
            loss_acc = loss_acc + loss.detach() / n_micro
            m_acc = {k: a + metrics[k].detach() / n_micro for k, a in m_acc.items()}
        del grads, loss, metrics
    # tokens were averaged; undo to keep the count semantic
    m_acc["tokens"] = m_acc["tokens"] * n_micro
    return loss_acc, m_acc, g_acc


def make_train_step(
    cfg,
    axes_tree=None,
    opt_cfg: AdamWConfig = AdamWConfig(),
    schedule_fn: Callable | None = None,
    step_cfg: TrainStepConfig = TrainStepConfig(),
    mesh=None,
):
    """Returns ``train_step(model, opt_state, batch)``."""
    if step_cfg.compress_pods:
        raise NotImplementedError(
            "compress_pods (the int8 error-feedback cross-pod reduction) is not ported yet: "
            "ROADMAP.md queue 1 item 10g")
    if mesh is not None:
        raise NotImplementedError(
            "a train step over a mesh is not ported yet: ROADMAP.md queue 1 item 10g")

    def loss_fn(model, batch):
        return lm.train_loss(model, cfg, batch)

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        loss, metrics, grads = _accumulated_grads(loss_fn, model, batch, step_cfg.n_micro)
        lr_scale = schedule_fn(opt_state["step"]) if schedule_fn is not None else 1.0
        model, new_opt, opt_metrics = adamw_update(
            grads, opt_state, model, opt_cfg, lr_scale, axes_tree)
        return model, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# --- serving -------------------------------------------------------------------


def make_prefill_step(cfg):
    def prefill_step(model, batch, cache):
        return lm.prefill(model, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, tokens, cache):
        return lm.decode_step(model, cfg, tokens, cache)

    return decode_step


def make_decode_sample_step(cfg, sampler_cfg: token_sampler.TokenSamplerConfig | None = None):
    """Decode + the paper's CIM-MCMC token sampler, fused into one step.

    The accept test uses logit differences only — no softmax normaliser is
    ever computed over the vocabulary.  Each chain starts at the row's
    input token.
    """
    scfg = sampler_cfg or token_sampler.TokenSamplerConfig(
        vocab_size=cfg.vocab_size, n_steps=32
    )

    def decode_sample_step(model, tokens, cache, key):
        logits, new_cache = lm.decode_step(model, cfg, tokens, cache)
        result = token_sampler._sample_tokens_impl(
            key, logits[:, : cfg.vocab_size], scfg, init_tokens=tokens[:, 0]
        )
        return result.tokens[:, None], new_cache, result.acceptance_rate

    return decode_sample_step
