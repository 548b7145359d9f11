"""Mamba-2 (SSD, state-space duality) layer, arXiv:2405.21060 — the port
of ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm, a loop over sequence chunks that
carries the inter-chunk state, so the intra-chunk (L x L) attention-like
matrix exists for one chunk at a time; decode is the O(1) recurrent step
on a (B, H, P, N) state.  ``mamba2_reference`` is the naive step-by-step
recurrence, the oracle for the chunked path.

The JAX package computes these in ``jnp`` outside any Pallas kernel, so
the port computes them in torch ops.  Unlike the JAX functions, a given
cache is written in place and returned (the server's stacked cache is one
allocation), as ``attention.attention`` writes the KV cache.  The state is
always float32; the conv caches keep their own dtype.

One departure from the reference: the intra-chunk decay is masked before
its exponent (see ``mamba2_full``), which gives the reference's value
wherever the reference is finite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models.layers import param, rms_norm


def init_mamba2(gen, cfg, device=None) -> nn.ParameterDict:
    """cfg: d_model, ssm_heads H, ssm_head_dim P, ssm_state N, ssm_groups G,
    ssm_conv K, param_dtype.  ``A_log``, ``D`` and ``dt_bias`` are float32."""
    d = cfg.d_model
    h, p, n, g, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    dt_ = cfg.param_dtype
    f32 = torch.float32
    return nn.ParameterDict({
        "wx": param(gen, (d, h, p), ("embed", "ssm_heads", "head_dim"), dt_, device=device),
        "wz": param(gen, (d, h, p), ("embed", "ssm_heads", "head_dim"), dt_, device=device),
        "wB": param(gen, (d, g, n), ("embed", None, "ssm_state"), dt_, device=device),
        "wC": param(gen, (d, g, n), ("embed", None, "ssm_state"), dt_, device=device),
        "wdt": param(gen, (d, h), ("embed", "ssm_heads"), dt_, device=device),
        "conv_x": param(gen, (k, h, p), ("conv", "ssm_heads", "head_dim"), dt_, scale=0.5,
                        device=device),
        "conv_B": param(gen, (k, g, n), ("conv", None, "ssm_state"), dt_, scale=0.5,
                        device=device),
        "conv_C": param(gen, (k, g, n), ("conv", None, "ssm_state"), dt_, scale=0.5,
                        device=device),
        "A_log": param(gen, (h,), ("ssm_heads",), f32, mode="zeros", device=device),
        "D": param(gen, (h,), ("ssm_heads",), f32, mode="ones", device=device),
        "dt_bias": param(gen, (h,), ("ssm_heads",), f32, mode="zeros", device=device),
        "norm": param(gen, (h, p), ("ssm_heads", "head_dim"), dt_, mode="ones", device=device),
        "out": param(gen, (h, p, d), ("ssm_heads", "head_dim", "embed"), dt_, device=device),
    })


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as XLA expands it."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv_full(x, w, cache=None):
    """Depthwise causal conv over time. x: (B,S,...ch), w: (K,...ch).
    Returns (out, the last K-1 inputs)."""
    k, s = w.shape[0], x.shape[1]
    if cache is None:
        xp = torch.cat([x.new_zeros((x.shape[0], k - 1, *x.shape[2:])), x], dim=1)
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i][None, None]
    new_cache = xp[:, -(k - 1):] if k > 1 else None
    return out, new_cache


def _project(params, x):
    """x: (B,S,d) -> xs (B,S,H,P), z, B (B,S,G,N), C, dt (B,S,H)."""
    b, s, d = x.shape

    def proj(w):
        return (x @ w.to(x.dtype).reshape(d, -1)).reshape(b, s, *w.shape[1:])

    return (proj(params["wx"]), proj(params["wz"]), proj(params["wB"]), proj(params["wC"]),
            proj(params["wdt"]))


def _write(cache, new):
    """Write ``new``'s leaves into the cache in place; returns the cache."""
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def _out(params, y, x):
    """Per-head RMS norm, then the output projection "bshp,hpd->bsd"."""
    b, s, d = x.shape
    y = rms_norm(y, params["norm"])
    w = params["out"].to(x.dtype)
    return y.to(x.dtype).reshape(b, s, -1) @ w.reshape(-1, d)


def mamba2_full(params, x, cfg, cache=None):
    """Training / prefill path. x: (B, S, d) -> (y (B,S,d), cache).

    Sequences that don't divide the chunk size are padded with *identity
    transitions*: padded steps get dt = 0, i.e. exp(dt*A) = 1 and zero
    input, so the carried state after step s is exact and the padded
    outputs are sliced off.  A given cache is read and then written in
    place with the state and conv inputs after the sequence.
    """
    b, s, d = x.shape
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    chunk = min(cfg.ssm_chunk, s)
    s_pad = ((s + chunk - 1) // chunk) * chunk
    nc = s_pad // chunk

    xs, z, bmat, cmat, dt = _project(params, x)
    conv = {}
    xs, conv["conv_x"] = _causal_conv_full(
        xs, params["conv_x"], None if cache is None else cache["conv_x"])
    bmat, conv["conv_B"] = _causal_conv_full(
        bmat, params["conv_B"], None if cache is None else cache["conv_B"])
    cmat, conv["conv_C"] = _causal_conv_full(
        cmat, params["conv_C"], None if cache is None else cache["conv_C"])
    xs, bmat, cmat = F.silu(xs), F.silu(bmat), F.silu(cmat)

    a_vec = -torch.exp(params["A_log"])                                 # (H,) negative
    dt = _softplus(dt.float() + params["dt_bias"])                      # (B,S,H)

    xs_p = xs
    if s_pad != s:
        def pad(t):  # zeros after the sequence; dt = 0 is the identity transition
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, s_pad - s))
        xs_p, bmat, cmat, dt = pad(xs), pad(bmat), pad(cmat), pad(dt)

    rep = h // g
    bmat_h = torch.repeat_interleave(bmat, rep, dim=2).float()          # (B,S,H,N)
    cmat_h = torch.repeat_interleave(cmat, rep, dim=2).float()
    xdt = xs_p.float() * dt[..., None]                                  # (B,S,H,P)
    loga = dt * a_vec                                                   # (B,S,H) <= 0

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h_prev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if cache is None else cache["state"].float())

    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xdt_i, b_i, c_i, la_i = xdt[:, sl], bmat_h[:, sl], cmat_h[:, sl], loga[:, sl]
        ca = torch.cumsum(la_i, dim=1)                                  # (B,L,H)
        a_tot = ca[:, -1]                                               # (B,H)
        # intra-chunk (diagonal) term.  The reference computes
        # exp(ca_l - ca_s) over the whole chunk and multiplies by the
        # causal mask afterwards (src/repro/models/ssm.py:149-150): above
        # the diagonal ca_l - ca_s is the chunk's accumulated -dt*A, which
        # is positive, and past ~88 the float32 exp is inf and inf * 0 is
        # NaN.  Masking before the exponent gives exp(-inf) = 0 there: the
        # reference's value wherever it is finite, the recurrence's where
        # it is NaN.
        att = torch.einsum("blhn,bshn->blsh", c_i, b_i)
        diff = ca[:, :, None] - ca[:, None, :]                          # (B,L,S,H)
        att = att * torch.exp(torch.where(tri[None, :, :, None], diff, float("-inf")))
        y = torch.einsum("blsh,bshp->blhp", att, xdt_i)
        # contribution of the carried state
        y = y + torch.einsum("blhn,bhpn,blh->blhp", c_i, h_prev, torch.exp(ca))
        # new carried state
        decay_in = torch.exp(a_tot[:, None] - ca)                       # (B,L,H)
        h_prev = h_prev * torch.exp(a_tot)[:, :, None, None] + torch.einsum(
            "blhn,blh,blhp->bhpn", b_i, decay_in, xdt_i)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y * F.silu(z.float())                                           # gated
    out = _out(params, y, x)

    if cache is not None:
        cache = _write(cache, {"state": h_prev, **conv})
    return out, cache


def mamba2_decode(params, x, cfg, cache):
    """Single-step recurrence. x: (B, 1, d); the cache is written in place."""
    h, g = cfg.ssm_heads, cfg.ssm_groups
    xs, z, bmat, cmat, dt = _project(params, x)

    def conv_step(t, w, cbuf):
        buf = torch.cat([cbuf.to(t.dtype), t], dim=1)                   # (B, K, ...)
        out = torch.einsum("bk...,k...->b...", buf, w.to(t.dtype))[:, None]
        return out, buf[:, 1:]

    conv = {}
    xs, conv["conv_x"] = conv_step(xs, params["conv_x"], cache["conv_x"])
    bmat, conv["conv_B"] = conv_step(bmat, params["conv_B"], cache["conv_B"])
    cmat, conv["conv_C"] = conv_step(cmat, params["conv_C"], cache["conv_C"])
    xs, bmat, cmat = F.silu(xs), F.silu(bmat), F.silu(cmat)

    a_vec = -torch.exp(params["A_log"])
    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]                # (B,H)
    rep = h // g
    b_h = torch.repeat_interleave(bmat[:, 0], rep, dim=1).float()       # (B,H,N)
    c_h = torch.repeat_interleave(cmat[:, 0], rep, dim=1).float()
    x_h = xs[:, 0].float()                                              # (B,H,P)

    da = torch.exp(dt * a_vec)                                          # (B,H)
    state = cache["state"].float()
    state = state * da[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", x_h, b_h, dt)
    y = torch.einsum("bhpn,bhn->bhp", state, c_h)
    y = y + params["D"][None, :, None] * x_h
    y = y[:, None] * F.silu(z.float())
    out = _out(params, y, x)
    return out, _write(cache, {"state": state, **conv})


def apply_mamba(fn, params, x, cfg, cache=None):
    """``fn`` (``mamba2_full`` or ``mamba2_decode``) on ``x``; under a mesh
    in a row-local region: each rank runs the layer on its own rows with
    the layer's weights whole, and its cache rows are written back after.
    Region: the chunked SSD's batched einsums (aten.bmm), whose DTensor
    strategy search on split heads took seconds a shape."""
    if not sharding.is_dtensor(x):
        return fn(params, x, cfg, cache)
    names, keys = list(params.keys()), list(cache or ())

    def body(x_, *rest):
        c = dict(zip(keys, rest[:len(keys)])) if cache is not None else None
        out, c = fn(dict(zip(names, rest[len(keys):])), x_, cfg, c)
        return (out, *(c[k] for k in keys))

    out, *new = sharding.local_region(body, sharding.split_placements(x), x,
                                      *(cache[k] for k in keys), *params.values(),
                                      shared=len(names))
    if cache is not None:
        for k, v in zip(keys, new):
            cache[k].copy_(v)
    return out, cache


def mamba2_reference(params, x, cfg):
    """Naive step-by-step recurrence (oracle for the chunked path)."""
    cache = init_ssm_cache(cfg, x.shape[0], n_layers=None, dtype=torch.float32,
                           device=x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = mamba2_decode(params, x[:, t:t + 1], cfg, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)


def init_ssm_cache(cfg, batch: int, n_layers=None, dtype=torch.bfloat16, device=None):
    """The state (float32) and the conv inputs (``dtype``); stacked
    (L-major) when n_layers is given."""
    h, p, n, g, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    lead = () if n_layers is None else (n_layers,)
    return {
        "state": torch.zeros((*lead, batch, h, p, n), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((*lead, batch, k - 1, h, p), dtype=dtype, device=device),
        "conv_B": torch.zeros((*lead, batch, k - 1, g, n), dtype=dtype, device=device),
        "conv_C": torch.zeros((*lead, batch, k - 1, g, n), dtype=dtype, device=device),
    }
