"""AdamW with global-norm clipping — the port of ``repro.optim.adamw``.

Moments are float32 whatever the parameter dtype; the update is applied
in float32 and cast back to the parameter's dtype (or kept in a float32
master copy with ``use_master``).  The state is a dict: ``step`` (an
int32 scalar on the parameters' device), and ``m``, ``v`` (and
``master``) keyed by parameter name, each a tensor of its parameter's
shape.  ``convert.named_to_tree`` gives it the JAX tree's layout for a
checkpoint.

``adamw_update`` writes the new parameters, the step counter, the
moments and the master copies in place (the full-width model's weights
and moments fill a large share of the card, and a captured train step
must read and write the state's own tensors) and returns them.  Its
arithmetic is JAX's as XLA compiles it on the CPU (measured bit for bit
there): the moments' ``b * m + (1 - b) * g`` is ``fma(b, m, (1 - b) *
g)``, written into the moment itself; the bias-corrected step ``(m / b1c) /
(sqrt(v / b2c) + eps)`` is rewritten ``m / (b1c * (sqrt(v / b2c) +
eps))``; and ``p - lr * (u + wd * p)`` is two fused multiply-adds,
``fma(-lr, fma(wd, p, u), p)``.  The fused multiply-adds are
``torch.addcmul``, whose CPU and CUDA kernels round once (held against
the emulation ``prng._fma32`` in the tests and on the card).  The square
root is IEEE's, as XLA's: torch's float32 ``sqrt`` on the CPU is not
always correctly rounded, so there it goes through float64 (exact for a
float32 argument).

ZeRO-1: the moments (and master copies) inherit each parameter's
logical axes plus a ZeRO extension (``zero_axes_tree``: the first
replicated dim divisible by the whole data-parallel extent is bound to
("pod", "data") by ``sharding.add_zero_axes``).  Given ``axes_tree``
under a mesh, ``adamw_update`` constrains ``m``, ``v`` and ``master`` to
those axes, so each data-parallel rank keeps its slice of them, and the
new parameters are brought back to their own placements (the
all-gather of ZeRO-1).  Without a mesh the constraints are the
identity.  Under those constraints (which may change a moment's
placements) the moments, master copies and step counter are new
tensors in the state's dicts.  The port's parameters are one tensor a
layer where the JAX tree stacks them, so a stacked leaf's ZeRO dim may
differ from JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import add_zero_axes, get_rules, leaf_axes, shard


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; schedules multiply this
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = False         # keep f32 master copies of bf16 params


def _named(params) -> dict:
    """``{name: tensor}`` from a module or a dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def zero_axes_tree(params, axes_tree: dict) -> dict:
    """Extend each parameter's logical axes with the ZeRO DP axis (under
    the active mesh; unchanged without one)."""
    named = _named(params)
    return {n: add_zero_axes(leaf_axes(axes_tree[n], p.ndim), tuple(p.shape))
            for n, p in named.items()}


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """The state ``{step, m, v[, master]}`` of a module's (or a name ->
    tensor dict's) parameters, on their device (DTensors keep their
    parameters' placements)."""
    named = _named(params)
    device = next(iter(named.values())).device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
              for n, p in named.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
              for n, p in named.items()},
    }
    if cfg.use_master:
        state["master"] = {n: p.detach().float().clone() for n, p in named.items()}
    return state


def opt_state_axes(params, axes_tree: dict, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """Logical axes for the opt state (ZeRO-extended) for sharding specs."""
    zaxes = zero_axes_tree(params, axes_tree)
    state_axes = {"step": (), "m": zaxes, "v": zaxes}
    if cfg.use_master:
        state_axes["master"] = zaxes
    return state_axes


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding (``b`` may be a 0-d
    tensor): ``torch.addcmul``, a fused multiply-add on both devices."""
    return torch.addcmul(c, a, b)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as XLA's float32 constant, a 0-d tensor on
    ``like``'s device: a fill there, since a copy from the host cannot be
    captured."""
    return torch.full((), np.float32(x), dtype=torch.float32, device=like.device)


def _madd(a, x, b, y, out=None):
    """``a * x + b * y`` (a, b scalars) with the one fused rounding of
    ``fma(a, x, b * y)``, into ``out`` when given (it may be ``x``)."""
    return torch.addcmul(y * b, x, _scalar(a, x), out=out)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, cfg: AdamWConfig = AdamWConfig(),
                 lr_scale=1.0, axes_tree=None):
    """One AdamW step.  ``grads`` maps parameter names to gradients;
    ``params`` is the module (or name -> tensor dict) they belong to.
    Returns (params, opt_state, metrics ``grad_norm``, ``lr``): the
    parameters, the step counter, the moments and the master copies are
    written in place, and the state returned is ``opt_state`` itself.
    With ``axes_tree`` the moments and master copies are constrained to
    their ZeRO axes (a no-op without a mesh) and, like the step counter,
    replaced in a new state dict."""
    named = _named(params)
    zaxes, rules = None, None
    if axes_tree is not None:
        zaxes = zero_axes_tree(named, axes_tree)
        rules = get_rules().replace(_zero=("pod", "data"))
    inplace = zaxes is None
    step = opt_state["step"].add_(1) if inplace else opt_state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    if not isinstance(lr_scale, torch.Tensor):
        lr_scale = torch.full((), np.float32(lr_scale), dtype=torch.float32, device=gn.device)
    lr = lr_scale.to(device=gn.device, dtype=torch.float32) * cfg.lr
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    masters = opt_state.get("master")
    for name, p in named.items():
        g = grads[name].float() * clip
        m_old, v_old = opt_state["m"][name], opt_state["v"][name]
        m = _madd(cfg.b1, m_old, 1.0 - cfg.b1, g, out=m_old if inplace else None)
        v = _madd(cfg.b2, v_old, 1.0 - cfg.b2, torch.square(g), out=v_old if inplace else None)
        del g
        if not inplace:
            m, v = shard(m, zaxes[name], rules), shard(v, zaxes[name], rules)
            opt_state["m"][name], opt_state["v"][name] = m, v
        update = m / (b1c * (_sqrt32(v / b2c) + cfg.eps))
        p32 = (masters[name] if masters is not None else p).float()
        p32_n = torch.addcmul(p32, fma(p32, _scalar(cfg.weight_decay, p32), update), -lr,
                              out=p32 if masters is not None and inplace else None)
        if masters is not None and not inplace:
            masters[name] = shard(p32_n, zaxes[name], rules)
        p.copy_(p32_n.to(p.dtype))
    new_state = opt_state if inplace else dict(opt_state, step=step)
    return params, new_state, {"grad_norm": gn, "lr": lr}
