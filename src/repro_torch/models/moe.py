"""Mixture-of-Experts FFN with top-k routing and capacity dispatch — the
port of ``repro.models.moe``.

``moe_ffn_local`` is the JAX package's single-program path: per batch
row, the (S*k) assignments are sorted by expert id, positions within
each expert come from segment arithmetic, and tokens past the static
per-expert capacity are dropped (combine weight zero), the GShard/Switch
discipline.  Every expert then runs over its whole capacity buffer, as
the JAX einsums do.  The B rows are batched with plain tensor ops, the
counterpart of JAX's ``vmap``; the three expert products are ``torch``
matrix products, as JAX computes them with ``jnp.einsum`` outside any
Pallas kernel.

What the port must keep so that routing and drops are JAX's exactly:

* the top k come from a stable descending sort, so equal probabilities
  give the lower expert id first, as ``lax.top_k`` does (``torch.topk``
  leaves the order of ties unspecified);
* the dispatch sorts with a stable argsort and finds each assignment's
  position with ``searchsorted(side="left")``, so the later tokens of an
  overfull expert are the ones dropped;
* the combine adds each token's k contributions in ascending expert id,
  the order of JAX's sorted scatter-add, one add at a time in the
  activations' dtype: a gather and a fixed sum, no atomics, so a
  bfloat16 result does not change from run to run;
* the router's product is float32 with TF32 off on the card, since its
  decisions are discrete.

Under a mesh (``sharding.use_mesh``) the same discipline runs on
DTensors.  ``moe_ffn`` reads the active mesh as the JAX function does:

* by default, ``moe_ffn_local(constrain=True)``: routing and the expert
  products stay in DTensor's hands (the expert-stacked weights sharded
  over "model"), with JAX's constraints on the dispatch buffers; the
  dispatch runs in a row-local region (``sharding.local_region``) on
  each rank's rows, since DTensor has no sharding strategy for
  ``searchsorted`` and the index writes, and the combine gathers each
  rank's own experts' contributions and reduces them once over the
  dimensions that split the experts (``_combine_sharded``), as XLA
  partitions JAX's gather and scatter-add;
* with ``REPRO_MOE_SHARD_MAP_EP=1`` (read once, at import),
  ``moe_ffn_ep``: JAX's ``shard_map`` over "model" as a manual region on
  local tensors.  Each rank routes its rows, dispatches to its own
  experts (``offset``), runs them, and one all-reduce over "model" sums
  the combine.  Its backward pass (``_ExpertParallel``, JAX's
  ``custom_vjp``) recomputes the local dispatch and all-reduces ``dx``
  and the router's gradient over "model"; the experts' gradients stay on
  their rank.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import active_mesh, shard
from repro_torch.models.layers import param


def init_moe(gen, cfg, device=None) -> nn.ParameterDict:
    """cfg: d_model, n_experts E, d_ff (per-expert hidden), param_dtype.
    The router is float32 whatever the parameter dtype is."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    dt = cfg.param_dtype
    return nn.ParameterDict({
        "router": param(gen, (d, e), ("embed", None), torch.float32, device=device),
        "w_gate": param(gen, (e, d, f), ("experts", "embed", "ffn"), dt, device=device),
        "w_up": param(gen, (e, d, f), ("experts", "embed", "ffn"), dt, device=device),
        "w_down": param(gen, (e, f, d), ("experts", "ffn", "embed"), dt, device=device),
    })


def capacity(tokens_per_row: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(tokens_per_row * top_k / n_experts * factor)
    return max(8, ((cap + 7) // 8) * 8)  # 8-aligned, as the JAX package pads it


@contextlib.contextmanager
def _full_float32(device):
    """Float32 products in full precision on the card (no TF32), whatever
    the process has set, restored on exit."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def route(router_w, x, top_k: int, renormalize: bool = True):
    """x: (..., d) -> (probs (..., k), experts (..., k) int64, aux scalar)."""
    e = router_w.shape[-1]
    with _full_float32(x.device):
        logits = (x.float().reshape(-1, x.shape[-1]) @ router_w).reshape(*x.shape[:-1], e)
    probs_full = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, the lower index first among equal values
    sorted_p, order = torch.sort(probs_full, dim=-1, descending=True, stable=True)
    probs, experts = sorted_p[..., :top_k], order[..., :top_k]
    if renormalize:
        probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    # load-balancing auxiliary loss (Switch-style), over all leading dims
    me = probs_full.reshape(-1, e).mean(dim=0)
    first = experts.reshape(-1, top_k)[:, 0]
    # the mean of one-hot rows, as JAX takes it (a bincount would wait
    # for the card to size its output)
    ce = (first[:, None] == torch.arange(e, device=x.device)).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return probs, experts, aux


def _dispatch(x, probs, experts, n_experts: int, top_k: int, cap: int, offset=0):
    """Every batch row's ``_dispatch_row`` at once, for the contiguous
    expert range [offset, offset + n_experts) (0 and E on one device, a
    rank's slice under expert parallelism): (B,S,d), (B,S,k), (B,S,k) ->
    the (B,n_experts,cap,d) buffer and, per row in sorted order, each
    assignment's slot (n_experts*cap when dropped or not local), token and
    combine weight."""
    b, s, d = x.shape
    dev = x.device
    flat_e = experts.reshape(b, s * top_k) - offset                     # (B, S*k)
    flat_p = probs.reshape(b, s * top_k)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(top_k)     # (S*k,)
    is_local = (flat_e >= 0) & (flat_e < n_experts)
    sort_key = torch.where(is_local, flat_e, n_experts)                 # non-local last
    order = torch.argsort(sort_key, dim=-1, stable=True)
    se = torch.gather(sort_key, 1, order)
    pos = torch.arange(s * top_k, device=dev) - torch.searchsorted(se, se, side="left")
    keep = (se < n_experts) & (pos < cap)
    slot = torch.where(keep, se * cap + pos, n_experts * cap)           # overflow slot
    tok = flat_tok[order]
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, n_experts * cap + 1, d), dtype=x.dtype, device=dev)
    # kept slots are distinct; every dropped assignment writes the extra
    # overflow row, which is cut off
    buf[rows, slot] = x[rows, tok]
    buf = buf[:, :n_experts * cap].reshape(b, n_experts, cap, d)
    weights = torch.where(keep, torch.gather(flat_p, 1, order), 0.0)
    return buf, (slot, tok, weights)


def _contributions(out_buf, slot, weights, lo=None):
    """(B,E,cap,d) expert outputs -> the (B,S*k,d) weighted contributions,
    in sorted order.  With ``lo``, ``out_buf`` holds the slots [lo, lo +
    E*cap) of a larger buffer: the others give zeros."""
    b, e, cap, d = out_buf.shape
    flat = out_buf.reshape(b, e * cap, d)
    rows = torch.arange(b, device=out_buf.device)[:, None]
    w = weights[..., None].to(flat.dtype)
    if lo is None:
        return flat[rows, torch.clamp_max(slot, e * cap - 1)] * w
    slot = slot - lo
    inside = (slot >= 0) & (slot < e * cap)
    return torch.where(inside[..., None], flat[rows, slot.clamp(0, e * cap - 1)] * w, 0)


def _token_sum(contrib, tok, s: int, top_k: int):
    """(B,S*k,d) contributions in sorted order -> (B,S,d): each token's k
    contributions added in ascending expert id (the order of JAX's sorted
    scatter-add) one at a time in their dtype."""
    b, _, d = contrib.shape
    rows = torch.arange(b, device=contrib.device)[:, None]
    # sorted order holds a token's assignments in ascending expert id; a
    # stable sort by token keeps that order within each token
    by_tok = torch.argsort(tok, dim=-1, stable=True)
    contrib = contrib[rows, by_tok].reshape(b, s, top_k, d)
    out = contrib[:, :, 0]
    for j in range(1, top_k):
        out = out + contrib[:, :, j]
    return out


def _combine(out_buf, info, s: int, top_k: int):
    """(B,E,cap,d) expert outputs -> (B,S,d)."""
    slot, tok, weights = info
    return _token_sum(_contributions(out_buf, slot, weights), tok, s, top_k)


def _combine_sharded(out_buf, info, s: int, top_k: int, rows):
    """``_combine`` of expert outputs split over their experts, as XLA
    partitions JAX's gather and scatter-add: each rank gathers the
    contributions of the slots its own experts hold (zeros for the
    rest), one sum over the dimensions that split the experts (an
    all-reduce of the (B, S*k, d) contributions) reduces them, and the
    token sums run on each rank's rows.  Each contribution has one
    non-zero term, so the result equals the unsplit combine bit for bit;
    the outputs never cross a link.  ``rows``: the info's placements."""
    from torch.distributed.tensor import Partial, Replicate

    slot, tok, weights = info
    mesh = out_buf.device_mesh
    # the rows split as the info's, the experts as they are
    buf_pl = [r if r.is_shard() else p if p.is_shard(1) else Replicate()
              for p, r in zip(out_buf.placements, rows)]
    out_buf = out_buf.redistribute(mesh, buf_pl)
    split = {i for i, p in enumerate(buf_pl) if p.is_shard(1)}
    (_, _, cap, _), (_, e0, _, _) = sharding.local_extent(out_buf.shape, mesh, buf_pl)

    def contributions(ob, slot_, weights_):
        return _contributions(ob, slot_, weights_, e0 * cap)

    part = [Partial() if i in split else p for i, p in enumerate(rows)]
    contrib = sharding.local_region(contributions, None, out_buf, slot, weights,
                                    out_placements=part)
    contrib = contrib.redistribute(mesh, rows)
    return sharding.local_region(lambda c, t: _token_sum(c, t, s, top_k), rows, contrib, tok)


def _expert_ffn(buf, wg, wu, wd, act):
    """buf: (B, E, cap, d) x stacked weights (E, d, f) -> (B, E, cap, d);
    the gated FFN whatever ``cfg.mlp_gated`` says, as in JAX."""
    b, e, cap, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * cap, d)
    hg = torch.bmm(xe, wg.to(buf.dtype))
    hu = torch.bmm(xe, wu.to(buf.dtype))
    out = torch.bmm(act(hg) * hu, wd.to(buf.dtype))
    return out.reshape(e, b, cap, d).transpose(0, 1)


def _moe_body(x, probs, experts, wg, wu, wd, cfg, act, offset=0, constrain=False):
    """Dispatch, the experts, and the combine for the local expert slice
    [offset, offset + wg.shape[0]).

    With ``constrain`` (the EP-capable path under a mesh), JAX's
    constraints pin the dispatch buffer replicated over "model" and the
    experts' outputs to ("batch" x "experts"), so the expert products run
    on each rank's own experts.  On DTensors the dispatch runs per batch
    row in a row-local region (DTensor has no sharding strategy for
    ``searchsorted``, nor for the index writes of the buffer), and the
    combine is ``_combine_sharded``."""
    s = x.shape[1]
    cap = capacity(s, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)

    def dispatch(x_, probs_, experts_):
        return _dispatch(x_, probs_, experts_, wg.shape[0], cfg.moe_top_k, cap, offset)

    rows = sharding.split_placements(x)
    # region: aten.searchsorted and aten.index_put_ (the dispatch)
    buf, info = sharding.local_region(dispatch, rows, x, probs, experts)
    if constrain:
        # the dispatch buffer stays replicated over "model": each rank's
        # expert products read their slice of it locally
        buf = shard(buf, ("batch", None, "expert_cap", "embed"))
    out_buf = _expert_ffn(buf, wg, wu, wd, act)
    if constrain:
        out_buf = shard(out_buf, ("batch", "experts", "expert_cap", "embed"))
    if rows is None:
        return _combine(out_buf, info, s, cfg.moe_top_k)
    return _combine_sharded(out_buf, info, s, cfg.moe_top_k, rows)


def moe_ffn_local(params, x, cfg, act, constrain=False):
    """The single-program path (constrained under a mesh). x: (B,S,d) ->
    (out, aux)."""
    probs, experts, aux = route(params["router"], x, cfg.moe_top_k,
                                renormalize=cfg.moe_renormalize)
    out = _moe_body(x, probs, experts, params["w_gate"], params["w_up"], params["w_down"],
                    cfg, act, offset=0, constrain=constrain)
    return out, aux


def _ep_local(x, rw, wg, wu, wd, cfg, act, offset):
    """One rank's share of the expert-parallel FFN on local tensors: its
    rows routed, dispatched to its experts [offset, offset + E_local)."""
    probs, experts, _ = route(rw, x, cfg.moe_top_k, renormalize=cfg.moe_renormalize)
    return _moe_body(x, probs, experts, wg, wu, wd, cfg, act, offset)


class _ExpertParallel(torch.autograd.Function):
    """JAX's ``custom_vjp`` around the EP ``shard_map``: the forward pass
    sums every rank's share over the group; the backward pass replays the
    local dispatch under autograd (recompute-style) and all-reduces ``dx``
    and the router's gradient, while the experts' gradients stay on their
    rank."""

    @staticmethod
    def forward(ctx, x, rw, wg, wu, wd, cfg, act, offset, group):
        import torch.distributed as dist

        ctx.save_for_backward(x, rw, wg, wu, wd)
        ctx.extra = (cfg, act, offset, group)
        out = _ep_local(x, rw, wg, wu, wd, cfg, act, offset)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dout):
        import torch.distributed as dist

        cfg, act, offset, group = ctx.extra
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _ep_local(*leaves, cfg, act, offset)
        grads = list(torch.autograd.grad(out, leaves, dout, allow_unused=True))
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        dist.all_reduce(grads[0], group=group)
        dist.all_reduce(grads[1], group=group)
        return (*grads, None, None, None, None)


def moe_ffn_ep(params, x, cfg, act, mesh, axis: str = "model"):
    """Expert-parallel path: experts manual over ``axis``, the rest in
    DTensor's hands.  The region's inputs are each rank's rows of ``x``
    (whole over ``axis``), the router whole, and the rank's slice of the
    expert-stacked weights; the output keeps ``x``'s rows.  A gradient
    taken from a rank's rows is a partial sum over the dimensions that
    split them, and is handed back as one.  The aux load-balancing loss
    is computed outside the region on DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = sharding.mesh_axis_names(mesh)
    m = names.index(axis)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    x_pl = sharding.split_placements(x)
    x_pl[m] = Replicate()
    w_pl = [Replicate()] * mesh.ndim
    w_pl[m] = Shard(0)
    r_pl = [Replicate()] * mesh.ndim
    split = [isinstance(p, Shard) for p in x_pl]

    def grad_pl(pl):  # a weight's gradient from this rank's rows
        return [Partial() if sp else p for sp, p in zip(split, pl)]

    def local(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl(pl))

    x_l = x.redistribute(mesh, x_pl).to_local()
    wg, wu, wd = (local(params[k], w_pl) for k in ("w_gate", "w_up", "w_down"))
    offset = mesh.get_local_rank(m) * wg.shape[0]
    out = _ExpertParallel.apply(x_l, local(params["router"], r_pl), wg, wu, wd, cfg, act,
                                offset, mesh.get_group(m))
    out = DTensor.from_local(out, mesh, x_pl, run_check=False)
    _, _, aux = route(params["router"], x, cfg.moe_top_k, renormalize=cfg.moe_renormalize)
    return out, aux


# The JAX package takes the shard_map EP path only under this environment
# variable (an XLA SPMD crash in its toolchain); read once, as there, so
# that both packages take the same path under the same environment.
USE_SHARD_MAP_EP = os.environ.get("REPRO_MOE_SHARD_MAP_EP", "0") == "1"


def moe_ffn(params, x, cfg, act):
    """Dispatching entry: EP-constrained when a mesh is active, else local."""
    mesh = active_mesh()
    names = sharding.mesh_axis_names(mesh) if mesh is not None else ()
    m = sharding.mesh_axis_size(mesh, "model") if "model" in names else 1
    ep_capable = m > 1 and cfg.n_experts % m == 0
    if ep_capable and USE_SHARD_MAP_EP:
        return moe_ffn_ep(params, x, cfg, act, mesh)
    out, aux = moe_ffn_local(params, x, cfg, act, constrain=ep_capable)
    return shard(out, ("batch", "seq", "embed")), aux


def moe_dense_reference(params, x, cfg, act):
    """All-experts dense evaluation (oracle for routing/combine tests).

    No capacity limit: equals the capacity path whenever no token
    overflows."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs, experts, _ = route(params["router"], xf, cfg.moe_top_k,
                              renormalize=cfg.moe_renormalize)
    hg = torch.einsum("nd,edf->nef", xf, params["w_gate"].to(x.dtype))
    hu = torch.einsum("nd,edf->nef", xf, params["w_up"].to(x.dtype))
    all_out = torch.einsum("nef,efd->ned", act(hg) * hu, params["w_down"].to(x.dtype))
    sel = torch.take_along_dim(all_out, experts[..., None], dim=1)  # (N, k, d)
    out = torch.sum(sel * probs[..., None].to(x.dtype), dim=1)
    return out.reshape(b, s, d)
