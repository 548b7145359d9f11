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
* **Over a mesh** (``mesh=``, a ``DeviceMesh`` whose dimensions carry
  the JAX mesh's names): the model's parameters are DTensors on it
  (``sharding.distribute_params``) and the step runs under
  ``sharding.use_mesh(mesh)``; the batch is the global batch, which
  every rank holds whole (the model splits its rows over the "batch"
  rule).  Each gradient is brought to its parameter's placements (a
  sum over the ranks that split the rows), the accumulators carry the
  same placements, and the metrics come back as plain tensors.
* **Compressed cross-pod DP** (``compress_pods``): the gradient
  computation is a region manual over "pod".  Each pod takes its rows of
  the batch and runs ``_accumulated_grads`` with the parameters seen on
  its sub-mesh of the other dimensions (reduced over "data" by DTensor);
  ``compression.compressed_pmean`` reduces the gradients over "pod" with
  the int8 error-feedback all-reduce, and a mean over "pod" the loss and
  metrics.  The update runs outside the region, on the whole mesh.  The
  error state is each pod's own (JAX's ``P()`` out-spec, unchecked): its
  leaves claim to be replicated over "pod" and hold the pod's residual.
* **ZeRO-1**: with ``axes_tree`` (``lm.LM.param_axes``) the optimizer
  moments are constrained over ("pod", "data") (see
  ``repro_torch.optim.adamw``).

Serving: ``make_prefill_step`` / ``make_decode_step`` close over the
config; ``make_decode_sample_step`` fuses the paper's CIM-MCMC token
sampler into the decode step (on the card its chain is the MH operand
kernel, ``csrc/mh.cu``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.core import token_sampler
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import compressed_pmean
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
        grads = _placed(torch.autograd.grad(loss, params), params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))

    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"a batch of {rows} rows does not split into {n_micro} microbatches")
    size = rows // n_micro
    g_acc = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
             for n, p in named.items()}
    dev = params[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in ("ce_loss", "aux_loss", "tokens")}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, metrics = loss_fn(model, mb)
        grads = _placed(torch.autograd.grad(loss, params), params)
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
    """Returns ``train_step(model, opt_state, batch[, err_state])``."""
    pod_axis = step_cfg.pod_axis
    if step_cfg.compress_pods and (
            mesh is None or pod_axis not in sharding.mesh_axis_names(mesh)):
        raise ValueError("compress_pods requires a mesh with a 'pod' axis")

    def loss_fn(model, batch):
        return lm.train_loss(model, cfg, batch)

    def on_mesh():
        return sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()

    def _update(model, opt_state, loss, metrics, grads):
        lr_scale = schedule_fn(opt_state["step"]) if schedule_fn is not None else 1.0
        model, new_opt, opt_metrics = adamw_update(
            grads, opt_state, model, opt_cfg, lr_scale, axes_tree)
        out = {"loss": loss, **metrics, **opt_metrics}
        return model, new_opt, {k: sharding.whole(v) for k, v in out.items()}

    if not step_cfg.compress_pods:

        def train_step(model, opt_state, batch):
            model.requires_grad_(True)
            with on_mesh():
                loss, metrics, grads = _accumulated_grads(loss_fn, model, batch,
                                                          step_cfg.n_micro)
                return _update(model, opt_state, loss, metrics, grads)

        return train_step

    names = sharding.mesh_axis_names(mesh)
    pod = names.index(pod_axis)
    inner = sharding.sub_mesh(mesh, tuple(n for n in names if n != pod_axis))
    n_pods = mesh.size(pod)

    def train_step(model, opt_state, batch, err_state):
        import torch.distributed as dist

        model.requires_grad_(True)
        group = mesh.get_group(pod)
        with on_mesh():
            rows = next(iter(batch.values())).shape[0]
            if rows % n_pods:
                raise ValueError(f"a batch of {rows} rows does not split over {n_pods} pods")
            size = rows // n_pods
            at = mesh.get_local_rank(pod) * size
            pod_batch = {k: v[at:at + size] for k, v in batch.items()}
            named = dict(model.named_parameters())
            # the pod region: this pod's rows, the parameters and error
            # state seen on the pod's sub-mesh
            local = {n: _to_inner(p, inner, pod).requires_grad_(True) for n, p in named.items()}
            err = {n: _to_inner(e, inner, pod) for n, e in err_state.items()}
            with sharding.manual_axes({pod_axis}), _params_swapped(model, local):
                loss, metrics, grads = _accumulated_grads(loss_fn, model, pod_batch,
                                                          step_cfg.n_micro)
                del local
                grads, new_err = compressed_pmean(grads, err, axis=pod_axis, n_pods=n_pods,
                                                  mesh=mesh)
                del err
                metrics = {"loss": loss, **metrics}
                for k, v in metrics.items():
                    v = sharding.whole(v).clone()
                    dist.all_reduce(v, group=group)
                    metrics[k] = v / n_pods
            loss = metrics.pop("loss")
            grads = {n: _from_inner(g, mesh, pod) for n, g in grads.items()}
            new_err = {n: _from_inner(e, mesh, pod) for n, e in new_err.items()}
            model, new_opt, out = _update(model, opt_state, loss, metrics, grads)
        return model, new_opt, out, new_err

    return train_step


def _placed(grads, params):
    """Each DTensor gradient brought to its parameter's placements (a
    partial sum over the ranks that split the rows is all-reduced)."""
    return [g.redistribute(p.device_mesh, p.placements) if sharding.is_dtensor(g) else g
            for g, p in zip(grads, params)]


def _to_inner(t, inner, pod: int):
    """A DTensor replicated over the pod dimension ``pod`` as a DTensor on
    the pod's sub-mesh ``inner``, sharing its storage (a leaf)."""
    from torch.distributed.tensor import DTensor

    placements = [p for i, p in enumerate(t.placements) if i != pod]
    return DTensor.from_local(t.to_local().detach(), inner, placements, run_check=False)


def _from_inner(t, mesh, pod: int):
    """A DTensor on the pod's sub-mesh as a DTensor on ``mesh`` claiming
    replication over the pod dimension (every pod holds its own value
    until a reduction over "pod" has made them equal)."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = list(t.placements)
    placements.insert(pod, Replicate())
    return DTensor.from_local(t.to_local(), mesh, placements, run_check=False)


@contextlib.contextmanager
def _params_swapped(model, values: dict):
    """The model's parameters replaced by ``values`` (by name) for the
    block, restored after."""
    owners = dict(model.named_modules())
    saved = {}
    for name, value in values.items():
        owner, _, leaf = name.rpartition(".")
        saved[name] = owners[owner]._parameters[leaf]
        owners[owner]._parameters[leaf] = value
    try:
        yield
    finally:
        for name, value in saved.items():
            owner, _, leaf = name.rpartition(".")
            owners[owner]._parameters[leaf] = value


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
        # under a mesh the sampler draws from the whole (gathered) logits
        result = token_sampler._sample_tokens_impl(
            key, sharding.whole(logits)[:, : cfg.vocab_size], scfg, init_tokens=tokens[:, 0]
        )
        return result.tokens[:, None], new_cache, result.acceptance_rate

    return decode_sample_step
