"""Basic layers and the parameter init rule — the port of
``repro.models.layers``.

Every parameter is a ``torch.nn.Parameter`` made by ``param(...)``, which
applies the JAX package's init rule (normal x scale, with scale
``1/sqrt(shape[-2])`` for a leaf of two or more axes and
``1/sqrt(shape[-1])`` for a vector, unless a scale is given; or all zeros,
or all ones) and records the leaf's logical sharding axes as its
``logical_axes`` attribute; ``lm.LM.param_axes`` gathers them into a table
for a sharding layer to read.  The values are drawn from an explicit
``torch.Generator`` on the target device, so they are not
``jax.random.normal``'s (whose inverse error function is XLA's): the two
packages hold the same function of the weights, and the weights cross
between them through ``repro_torch.convert.lm_from_numpy``.

Parameters are made with ``requires_grad=False``: serving records no
graph; training turns gradients on for the model it trains
(``training.step.make_train_step``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding


def param(gen, shape, axes, dtype=torch.float32, scale: float | None = None,
          mode: str = "normal", device=None) -> nn.Parameter:
    """One parameter leaf with its logical axis names.

    ``gen`` is the ``torch.Generator`` the normal draw takes (its device
    is the leaf's); ``gen=None`` allocates the leaf uninitialised on
    ``device`` for a caller that fills it (the weight converter)."""
    shape = tuple(int(d) for d in shape)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {shape}")
    device = gen.device if gen is not None else device
    if gen is None:
        value = torch.empty(shape, dtype=dtype, device=device)
    elif mode == "zeros":
        value = torch.zeros(shape, dtype=dtype, device=device)
    elif mode == "ones":
        value = torch.ones(shape, dtype=dtype, device=device)
    else:
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / np.sqrt(max(1, fan_in))
        value = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        value = (value * float(scale)).to(dtype)
    leaf = nn.Parameter(value, requires_grad=False)
    leaf.logical_axes = tuple(axes)
    return leaf


# --- numerics --------------------------------------------------------------


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type the float32 parts of the JAX functions compute in: float32,
    or float64 for a model run in float64 as a reference."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(wide(dtype))
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.to(x.dtype)).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(wide(dtype))
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * weight.to(x.dtype) + bias.to(x.dtype)).to(dtype)


def activation(name: str):
    # jax.nn.gelu approximates with tanh unless told otherwise
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


class _MmFloat32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)``, which has no derivative of
    its own, with one: the backward pass runs the plain products on the
    widened operands and casts each gradient to its operand's dtype, as
    JAX's transposed dots give them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = (grad @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            grad_b = (a.float().t() @ grad).to(b.dtype)
        return grad_a, grad_b


def matmul_f32(a, b):
    """``a @ b`` with float32 results, as the JAX package's dots with
    ``preferred_element_type=float32``: the operands' products summed in
    float32.  On the card two matrices of one narrower type take
    ``torch.mm(..., out_dtype=float32)`` (cuBLAS sums in float32 and
    writes float32: the head's product, whose weight is too large to
    widen every step), through ``_MmFloat32`` so that training can
    differentiate it; other operands are widened first, which is exact
    (a bfloat16 product fits a float32), so the sum is the same function.
    Two float64 operands keep float64 (a model run in float64 as a
    reference for the float32 one)."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.ndim == 2 and b.ndim == 2 and sharding.is_dtensor(a):
        return _matmul_f32_region(a, b)
    if a.is_cuda and a.ndim == 2 and b.ndim == 2 and a.dtype == b.dtype:
        return _MmFloat32.apply(a, b)
    return a.float() @ b.float()


def _matmul_f32_region(a, b):
    """``matmul_f32`` of a DTensor matrix product on local tensors, since
    DTensor has no sharding strategy for ``aten.mm.dtype`` (``torch.mm``'s
    ``out_dtype``): the rows of ``a`` keep their split, the columns of
    ``b`` theirs, and each rank multiplies its blocks with no
    communication.  A gradient taken from a block is a partial sum over
    the mesh dimensions that split the other operand."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = a.device_mesh
    if not isinstance(b, DTensor):
        b = DTensor.from_local(b, mesh, [Replicate()] * mesh.ndim, run_check=False)
    a_pl, b_pl, out_pl, a_grad, b_grad = [], [], [], [], []
    for pa, pb in zip(a.placements, b.placements):
        if isinstance(pa, Shard) and pa.dim == 0:
            a_pl.append(pa), b_pl.append(Replicate()), out_pl.append(Shard(0))
            a_grad.append(pa), b_grad.append(Partial())
        elif isinstance(pb, Shard) and pb.dim == 1:
            a_pl.append(Replicate()), b_pl.append(pb), out_pl.append(Shard(1))
            a_grad.append(Partial()), b_grad.append(pb)
        else:
            for acc in (a_pl, b_pl, out_pl, a_grad, b_grad):
                acc.append(Replicate())
    a_l = a.redistribute(mesh, a_pl).to_local(grad_placements=a_grad)
    b_l = b.redistribute(mesh, b_pl).to_local(grad_placements=b_grad)
    return DTensor.from_local(matmul_f32(a_l, b_l), mesh, out_pl, run_check=False)


# --- rotary position embedding --------------------------------------------


def _inverse_frequencies(d_head: int, theta: float, device):
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))
    return torch.tensor(inv, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _cached_frequencies(d_head: int, theta: float, device):
    return _inverse_frequencies(d_head, theta, device)


def rope_frequencies(d_head: int, theta: float = 10000.0, device=None):
    """The inverse frequencies in float64 numpy, then float32, as JAX makes
    them; kept per (d_head, theta, device) for the life of the process, so
    a decode step copies nothing from the host (a copy from pageable
    memory waits for the card, and cannot be captured) and the table a
    captured decode program reads is never freed.  Under a fake tensor
    mode (a dry run) the table is made anew and never kept: a kept fake
    tensor would reach the real steps after it.  Callers must not write
    to the tensor."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return _inverse_frequencies(d_head, theta, device)
    return _cached_frequencies(d_head, theta, device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, dh) with positions (..., S) -> rotated x, f32 math."""
    dh = x.shape[-1]
    w = wide(x.dtype)
    inv = rope_frequencies(dh, theta, device=x.device).to(w)
    angles = positions[..., None].to(w) * inv                      # (..., S, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(w), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
