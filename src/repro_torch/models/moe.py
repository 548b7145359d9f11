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

``moe_ffn_ep`` (shard_map expert parallelism) is not ported: ``moe_ffn``
with a mesh raises (ROADMAP.md queue 1 item 10g).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

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


def _dispatch(x, probs, experts, n_experts: int, top_k: int, cap: int):
    """Every batch row's ``_dispatch_row`` at once, over all the experts
    (the JAX function's local range is [0, E) on one device): (B,S,d),
    (B,S,k), (B,S,k) -> the (B,E,cap,d) buffer and, per row in sorted
    order, each assignment's slot (E*cap when dropped), token and combine
    weight."""
    b, s, d = x.shape
    dev = x.device
    flat_e = experts.reshape(b, s * top_k)                              # (B, S*k)
    flat_p = probs.reshape(b, s * top_k)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(top_k)     # (S*k,)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    pos = torch.arange(s * top_k, device=dev) - torch.searchsorted(se, se, side="left")
    keep = pos < cap
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


def _combine(out_buf, info, s: int, top_k: int):
    """(B,E,cap,d) expert outputs -> (B,S,d): each token's k weighted
    contributions, added in ascending expert id (the order of JAX's
    sorted scatter-add) one at a time in the buffer's dtype."""
    slot, tok, weights = info
    b, e, cap, d = out_buf.shape
    flat = out_buf.reshape(b, e * cap, d)
    rows = torch.arange(b, device=out_buf.device)[:, None]
    contrib = flat[rows, torch.clamp_max(slot, e * cap - 1)] * weights[..., None].to(flat.dtype)
    # sorted order holds a token's assignments in ascending expert id; a
    # stable sort by token keeps that order within each token
    by_tok = torch.argsort(tok, dim=-1, stable=True)
    contrib = contrib[rows, by_tok].reshape(b, s, top_k, d)
    out = contrib[:, :, 0]
    for j in range(1, top_k):
        out = out + contrib[:, :, j]
    return out


def _expert_ffn(buf, wg, wu, wd, act):
    """buf: (B, E, cap, d) x stacked weights (E, d, f) -> (B, E, cap, d);
    the gated FFN whatever ``cfg.mlp_gated`` says, as in JAX."""
    b, e, cap, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * cap, d)
    hg = torch.bmm(xe, wg.to(buf.dtype))
    hu = torch.bmm(xe, wu.to(buf.dtype))
    out = torch.bmm(act(hg) * hu, wd.to(buf.dtype))
    return out.reshape(e, b, cap, d).transpose(0, 1)


def _moe_body(x, probs, experts, wg, wu, wd, cfg, act):
    """Dispatch, the experts, and the combine."""
    s = x.shape[1]
    cap = capacity(s, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
    buf, info = _dispatch(x, probs, experts, wg.shape[0], cfg.moe_top_k, cap)
    return _combine(_expert_ffn(buf, wg, wu, wd, act), info, s, cfg.moe_top_k)


def moe_ffn_local(params, x, cfg, act):
    """The single-program path. x: (B,S,d) -> (out, aux)."""
    probs, experts, aux = route(params["router"], x, cfg.moe_top_k,
                                renormalize=cfg.moe_renormalize)
    out = _moe_body(x, probs, experts, params["w_gate"], params["w_up"], params["w_down"],
                    cfg, act)
    return out, aux


def moe_ffn(params, x, cfg, act, mesh=None):
    """The dispatching entry: the local path; expert parallelism over a
    mesh is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "the MoE FFN over a mesh (moe_ffn_ep) is not ported yet: ROADMAP.md queue 1 "
            "item 10g")
    return moe_ffn_local(params, x, cfg, act)


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
