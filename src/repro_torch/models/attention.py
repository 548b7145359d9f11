"""Grouped-query attention with RoPE, sliding windows, and a blockwise
(flash-style) softmax for long sequences — the port of
``repro.models.attention``.

The blockwise path never materialises the full (Sq, Sk) score matrix: it
walks query blocks (outer) and key/value blocks (inner) carrying the
running max / normaliser / accumulator, with the JAX package's block
sizes, padding and recurrence.  The JAX package computes attention in
``jnp`` outside any Pallas kernel, so the port computes it in torch ops;
no library attention kernel is used.

Scores and the value products are float32 whatever the operands' type,
as the JAX package's einsums ask with ``preferred_element_type``
(``layers.matmul_f32``).

The JAX package's ``_gqa_layout`` and ``shard(...)`` annotations place
heads and the cache on a device mesh (``sharding.use_mesh``); without a
mesh they are the identity.  A decode step writes the KV cache in place
(the stacked buffer is the server's one allocation), and so does a
cross-attention prefill (the encoder's K/V, stored once for the decode
steps); a cache sharded over its sequence axis (the configs'
``cache_seq`` override) is written by each rank into its own rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import active_mesh, shard
from repro_torch.models.layers import apply_rope, matmul_f32, param, rms_norm, wide

NEG_INF = -1e30
GLOBAL_WINDOW = 2**30  # "no window" sentinel


def init_attention(gen, cfg, device=None) -> torch.nn.ParameterDict:
    """cfg needs: d_model, n_heads, n_kv_heads, d_head, param_dtype, qk_norm."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dtype = cfg.param_dtype
    p = {
        "wq": param(gen, (d, h, dh), ("embed", "heads", "head_dim"), dtype, device=device),
        "wk": param(gen, (d, kv, dh), ("embed", "kv_heads", "head_dim"), dtype, device=device),
        "wv": param(gen, (d, kv, dh), ("embed", "kv_heads", "head_dim"), dtype, device=device),
        "wo": param(gen, (h, dh, d), ("heads", "head_dim", "embed"), dtype, device=device),
    }
    if getattr(cfg, "qk_norm", False):
        p["q_norm"] = param(gen, (dh,), ("head_dim",), dtype, mode="ones", device=device)
        p["k_norm"] = param(gen, (dh,), ("head_dim",), dtype, mode="ones", device=device)
    return torch.nn.ParameterDict(p)


def _mask(q_pos, k_pos, window, causal: bool, sk_valid=None):
    """q_pos: (bq,), k_pos: (bk,) -> (bq, bk) bool validity mask."""
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if sk_valid is not None:
        valid &= k_pos[None, :] < sk_valid  # key-side padding
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            valid &= (q_pos[:, None] - k_pos[None, :]) < window
    return valid


def _scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded as float32 arithmetic rounds it (``1.0 /
    jnp.sqrt(dh)``), as a Python number: a factor that crosses no copy."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _q_block(qt, q_pos, kb, vb, n_kv: int, block_kv: int, window, causal, sk_valid, scale):
    """One query block against its first ``n_kv`` key/value blocks.

    qt: (B, KV, R, bq, dh); kb, vb: (nk, B, bk, KV, dh).  Returns
    (B, bq, KV, R, dh) float32 (float64 for float64 operands)."""
    b, kvh, r, bq, dh = qt.shape
    dev, acc_dtype = qt.device, wide(qt.dtype)
    m_run = torch.full((b, kvh, r, bq), NEG_INF, dtype=acc_dtype, device=dev)
    l_run = torch.zeros((b, kvh, r, bq), dtype=acc_dtype, device=dev)
    acc = torch.zeros((b, kvh, r, bq, dh), dtype=acc_dtype, device=dev)
    for kj in range(n_kv):
        kt = kb[kj].transpose(1, 2)  # (B, KV, bk, dh)
        vt = vb[kj].transpose(1, 2)
        k_pos = kj * block_kv + torch.arange(block_kv, device=dev)
        mask = _mask(q_pos, k_pos, window, causal, sk_valid)
        s = matmul_f32(qt, kt[:, :, None].transpose(-1, -2)) * scale  # (B,KV,R,bq,bk)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m_run - m_new)
        l_run = l_run * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + matmul_f32(p.to(vt.dtype), vt[:, :, None])
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)  # (B, bq, KV, R, dh)


def flash_attention(
    q, k, v, *, causal: bool, window, q_offset: int, block_q: int, block_kv: int,
    unroll_causal_skip: bool = False,
):
    """Blockwise softmax attention.

    q: (B, Sq, KV, R, dh); k, v: (B, Sk, KV, dh).  window may be None or
    an int.  q_offset is the absolute position of q[:, 0].  Returns
    (B, Sq, KV, R, dh) in q's dtype.  With ``unroll_causal_skip`` (causal,
    no window) query block i visits only the key blocks its positions
    can see, and padded keys are left to the causal mask, as in JAX.
    """
    b, sq, kvh, r, dh = q.shape
    sk = k.shape[1]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, sk)
    sq_orig, sk_orig = sq, sk
    # pad seq dims to block multiples; padded keys are masked, padded query
    # rows are sliced off the output
    if sq % block_q:
        pad = block_q - sq % block_q
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        sq += pad
    if sk % block_kv:
        pad = block_kv - sk % block_kv
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        sk += pad
    sk_valid = sk_orig if sk != sk_orig else None
    scale = _scale(dh)

    nq, nk = sq // block_q, sk // block_kv
    qb = q.reshape(b, nq, block_q, kvh, r, dh).transpose(0, 1)  # (nq, B, bq, KV, R, dh)
    kb = k.reshape(b, nk, block_kv, kvh, dh).transpose(0, 1)    # (nk, B, bk, KV, dh)
    vb = v.reshape(b, nk, block_kv, kvh, dh).transpose(0, 1)

    skip = unroll_causal_skip and causal and window is None
    outs = []
    for qi in range(nq):
        qt = qb[qi].permute(0, 2, 3, 1, 4)  # (B, KV, R, bq, dh)
        q_pos = q_offset + qi * block_q + torch.arange(block_q, device=q.device)
        if skip:  # static per-block key extent: true causal FLOP skipping
            hi = min(nk, (qi * block_q + block_q + block_kv - 1) // block_kv)
            outs.append(_q_block(qt, q_pos, kb, vb, hi, block_kv, None, True, None, scale))
        else:
            outs.append(_q_block(qt, q_pos, kb, vb, nk, block_kv, window, causal, sk_valid,
                                 scale))
    out = torch.cat(outs, dim=1)
    return out[:, :sq_orig].to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, index, window):
    """Single-token attention against a (B, Smax, KV, dh) cache.

    q: (B, 1, KV, R, dh); index = number of valid cache entries (q is at
    position index - 1; the cache already holds this step's k/v).
    ``index`` is a scalar or a (B,) per-row index.
    """
    b, _, kvh, r, dh = q.shape
    smax = k_cache.shape[1]
    dev = q.device
    scale = _scale(dh)
    qt = q[:, 0]  # (B, KV, R, dh)
    pos = torch.arange(smax, device=dev)
    # scalar -> per-row; a cross-attention's int length is filled on the
    # card (a copy from the host cannot be captured in a CUDA graph)
    idx = (torch.as_tensor(index, device=dev) if isinstance(index, torch.Tensor)
           else torch.full((), index, dtype=torch.int64, device=dev)).broadcast_to((b,))
    q_pos = idx - 1
    valid = pos[None, :] < idx[:, None]  # (B, Smax)
    if window is not None:
        valid &= (q_pos[:, None] - pos[None, :]) < window
    s = matmul_f32(qt, k_cache.permute(0, 2, 3, 1)) * scale  # (B, KV, R, Smax)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    # jax.nn.softmax: exp(s - max) over its sum, a true division
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = matmul_f32(p.to(v_cache.dtype), v_cache.transpose(1, 2))  # (B, KV, R, dh)
    return out[:, None].to(q.dtype)  # (B, 1, KV, R, dh)


def _decode_plan(q, k_cache, group: int):
    """The JAX package's plan for a decode step on a mesh: the cache's
    placements in the region (a split of ``head_dim`` brought whole), q's
    placements there and the mesh dimensions that split the cache's
    sequence.  On each mesh dimension q takes the cache's split of the
    batch rows, is whole where the cache's sequence is split, and keeps
    its heads split where the cache's KV heads are split alike or the
    cache is whole over it (if each rank's heads then fall in whole GQA
    groups or in one)."""
    from torch.distributed.tensor import Replicate

    mesh = k_cache.device_mesh
    kp = [Replicate() if p.is_shard() and p.dim > 2 else p for p in k_cache.placements]
    target, seq_dims = [], []
    for i, (k_p, q_p) in enumerate(zip(kp, q.placements)):
        if k_p.is_shard(0) or k_p.is_shard(2):
            target.append(k_p)
        elif k_p.is_shard(1):
            target.append(Replicate())
            seq_dims.append(i)
        else:
            target.append(q_p if q_p.is_shard(2) else Replicate())
    heads = q.shape[2] * q.shape[3]
    for i, p in enumerate(target):
        if p.is_shard(2):
            heads //= mesh.size(i)
    if heads % group and group % heads:  # a rank's heads would straddle groups
        target = [Replicate() if p.is_shard(2) and kp[i] == Replicate() else p
                  for i, p in enumerate(target)]
    return kp, target, seq_dims


def decode_attention_sharded(q, k_cache, v_cache, *, index, window, group: int):
    """``decode_attention`` on a mesh, in a local region, by
    ``_decode_plan``: q (B, 1, E, R', dh) in its ``_gqa_layout`` (E x R'
    heads, ``group`` of them to a KV head), the cache (B, Smax, KV, dh)
    as placed.  Each rank scores its heads against its rows of the cache,
    masked at their absolute positions; where the cache's sequence is
    split, the softmax is combined across the shards (an all-reduce of
    the row maxima, one of the sums, JAX's true division, then one of the
    value products), and a shard with no valid position weighs zero.
    Returns (B, 1, E, R', dh) with q's placements in the region; on one
    rank, ``decode_attention``'s arithmetic bit for bit."""
    import torch.distributed as dist

    mesh = k_cache.device_mesh
    kp, target, seq_dims = _decode_plan(q, k_cache, group)
    if kp != list(k_cache.placements):
        k_cache, v_cache = k_cache.redistribute(mesh, kp), v_cache.redistribute(mesh, kp)
    q = q.redistribute(mesh, target)
    b, _, _, re, dh = q.shape
    (nb, _, ne, _, _), (_, _, e0, _, _) = sharding.local_extent(q.shape, mesh, target)
    (_, n1, _, _), (o0, o1, k0, _) = sharding.local_extent(k_cache.shape, mesh, kp)
    n_heads, h0 = ne * re, e0 * re  # this rank's heads and the first one
    ng, rl = (n_heads // group, group) if n_heads % group == 0 else (1, n_heads)
    g0 = h0 // group - k0  # the local KV head of the first
    groups = [mesh.get_group(i) for i in seq_dims]

    def region(q_, k_, v_):
        dev = q_.device
        pos = o1 + torch.arange(n1, device=dev)
        idx = torch.as_tensor(index, device=dev).broadcast_to((b,))[o0:o0 + nb]
        valid = pos[None, :] < idx[:, None]  # (b, n1): this rank's rows
        if window is not None:
            valid &= (idx[:, None] - 1 - pos[None, :]) < window
        qt = q_[:, 0].reshape(nb, ng, rl, dh)
        kt, vt = k_[:, :, g0:g0 + ng], v_[:, :, g0:g0 + ng]
        s = matmul_f32(qt, kt.permute(0, 2, 3, 1)) * _scale(dh)  # (b, G, R, n1)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(denom, group=g)
        out = matmul_f32((e / denom).to(vt.dtype), vt.transpose(1, 2))  # (b, G, R, dh)
        for g in groups:
            dist.all_reduce(out, group=g)
        return out.reshape(q_.shape).to(q_.dtype)

    return sharding.local_region(region, None, q, k_cache, v_cache, out_placements=target)


def _gqa_layout(kv: int, r: int):
    """Pick (kv_eff, r_eff, repeat) so the sharded head axis divides "model".

    Layout A: kv divides |model|  -> shard the kv axis, keep GQA grouping.
    Layout B: only h = kv*r does  -> repeat K/V to h heads, shard flat heads.
    Layout C: neither divides     -> keep GQA grouping, weights replicate
                                     (divisibility filter in sharding rules).
    """
    mesh = active_mesh()
    if mesh is None or "model" not in sharding.mesh_axis_names(mesh):
        return kv, r, False
    m = sharding.mesh_axis_size(mesh, "model")
    if m <= 1 or kv % m == 0:
        return kv, r, False
    if (kv * r) % m == 0:
        return kv * r, 1, True
    return kv, r, False


def _update_rows_sharded(buf, upd, start, s: int, last: int) -> None:
    """``update_rows`` into a DTensor ``buf``: ``upd`` is brought to
    ``buf``'s placements whole along the sequence axis, and each rank
    writes the positions that fall in its own rows (an explicit region:
    DTensor cannot index-write a sharded dimension)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in buf.placements]
    if not isinstance(upd, DTensor):
        upd = DTensor.from_local(upd, mesh, [Replicate()] * mesh.ndim, run_check=False)
    upd_l = upd.redistribute(mesh, pl).to_local().to(buf.dtype)
    (n0, n1), (o0, o1) = sharding.local_extent(buf.shape[:2], mesh, buf.placements)
    buf_l = buf.to_local()
    if isinstance(start, int):
        start = min(max(start, 0), last)
        lo, hi = max(start, o1), min(start + s, o1 + n1)
        if lo < hi:
            buf_l[:, lo - o1:hi - o1] = upd_l[:, lo - start:hi - start]
        return
    if isinstance(start, DTensor):
        start = start.full_tensor()
    dev = buf_l.device
    pos = start.to(dev).clamp(0, last).reshape(-1, 1) + torch.arange(s, device=dev)
    if n0 == 0 or n1 == 0:
        return
    # a write of static shape (n0, s): each of the s positions lands on its
    # local column clamped into this rank's rows, and carries what that
    # column must end with (the update of the position really there, or
    # the column's own value), so the duplicates a clamp makes agree
    pos = pos.broadcast_to((buf.shape[0], s))[o0:o0 + n0] - o1  # local columns
    col = pos.clamp(0, n1 - 1)
    src = torch.arange(s, device=dev) + (col - pos)  # the position written at col
    inside = (src >= 0) & (src < s)
    rows = torch.arange(n0, device=dev)[:, None]
    new = upd_l[rows, src.clamp(0, s - 1)]
    keep = buf_l[rows, col]
    mask = inside.reshape(inside.shape + (1,) * (new.ndim - 2))
    buf_l[rows, col] = torch.where(mask, new, keep)


def update_rows(buf, upd, start) -> None:
    """``jax.lax.dynamic_update_slice`` of ``upd`` (B, s, ...) into
    ``buf`` (B, Smax, ...) along the sequence axis at ``start`` (a
    non-negative int or scalar tensor, or a (B,) per-row start as under
    ``vmap``), in place.  Each start is clamped to [0, Smax - s] as XLA clamps it: an idle server
    slot keeps decoding past its cache, and its rows then rewrite the
    last position.  An update longer than the buffer raises
    ``ValueError``, whatever the start, where JAX raises ``TypeError``:
    a clamped start would be negative and wrap."""
    b, s = upd.shape[:2]
    last = buf.shape[1] - s
    if last < 0:
        raise ValueError(
            f"an update of shape {tuple(upd.shape)} is longer than the buffer of shape "
            f"{tuple(buf.shape)} along the sequence axis")
    if sharding.is_dtensor(buf):
        _update_rows_sharded(buf, upd, start, s, last)
        return
    if isinstance(start, int):  # a prefill's 0: a slice, no index tensor
        start = min(max(start, 0), last)
        buf[:, start:start + s] = upd.to(buf.dtype)
        return
    dev = buf.device
    pos = start.clamp(0, last).reshape(-1, 1) + torch.arange(s, device=dev)  # (1 or B, s)
    buf[torch.arange(b, device=dev)[:, None], pos] = upd.to(buf.dtype)


def attention(
    params,
    x,
    cfg,
    *,
    positions,
    mode: str,
    cache=None,
    cache_index=None,
    window=None,
    causal: bool = True,
    kv_input=None,
    use_rope: bool = True,
    cross: bool = False,
):
    """Full attention layer.  Returns (out, new_cache).

    mode: "full" (train / prefill over the whole sequence) or "decode".
    Self-attention cache: dict(k, v) of (B, Smax, KV, dh), written in
    place; ``cache_index`` is the number of valid entries *before* this
    call (an int32 scalar or (B,) tensor).  Cross-attention
    (``cross=True``): K/V come from ``kv_input`` in full mode (and are
    written into the cache, cast to its dtype), or from ``cache`` in
    decode, which reads all of it and writes nothing.
    """
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    r = h // kv

    def project(src, w, heads):  # "bsd,dhk->bshk"
        return (src @ w.to(x.dtype).reshape(d, heads * dh)).reshape(*src.shape[:2], heads, dh)

    q = project(x, params["wq"], h)
    kv_src = kv_input if cross else x
    k = v = None  # cross-attention decode reads the prefilled cache
    if not (cross and mode == "decode"):
        k = project(kv_src, params["wk"], kv)
        v = project(kv_src, params["wv"], kv)

    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        if k is not None:
            k = rms_norm(k, params["k_norm"])

    if use_rope and not cross:
        q = _rope_heads(q, positions, cfg.rope_theta)
        k = _rope_heads(k, positions, cfg.rope_theta)

    kv_eff, r_eff, repeat_kv = _gqa_layout(kv, r)
    q = q.reshape(b, s, kv_eff, r_eff, dh)
    q = shard(q, ("batch", "seq", "kv_heads", None, "head_dim"))

    new_cache = cache
    if mode == "decode":
        # decode keeps the native GQA grouping: the cache's sequence axis
        # supplies the model-axis parallelism (cache_seq sharding rules)
        def cache_shard(t):
            return shard(t, ("batch", "cache_seq", "kv_heads", "head_dim"))

        if not cross:
            # append this step's k/v at the cache index; a (B,) per-row
            # index writes each row at its own position
            update_rows(cache["k"], k, cache_index)
            update_rows(cache["v"], v, cache_index)
            index = cache_index + s
        else:
            index = cache["k"].shape[1]
        k_cache, v_cache = cache_shard(cache["k"]), cache_shard(cache["v"])
        window = None if cross else window
        if sharding.is_dtensor(k_cache):
            out = decode_attention_sharded(q, k_cache, v_cache, index=index, window=window,
                                           group=r)
        else:
            out = decode_attention(q.reshape(b, s, kv, r, dh), k_cache, v_cache, index=index,
                                   window=window)
        out = out.reshape(b, s, h, dh)
    else:
        if cache is not None and not cross:  # prefill: the whole sequence into the cache
            update_rows(cache["k"], k, 0)
            update_rows(cache["v"], v, 0)
        elif cache is not None:  # whisper prefill: stash the encoder's K/V for decode
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        if repeat_kv:  # layout B: K/V repeated to the flat heads
            k, v = torch.repeat_interleave(k, r, dim=2), torch.repeat_interleave(v, r, dim=2)

        def flash(q_, k_, v_):
            return flash_attention(
                q_, k_, v_,
                causal=causal,
                window=window,
                q_offset=0,
                block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv,
                unroll_causal_skip=getattr(cfg, "attn_causal_skip", False),
            )

        # region: aten.bmm of the blockwise score and value products.  Each
        # (row, KV head) attends on its own, so the blocks run on each rank's
        # rows and heads (q's split of dims 0 and 2, which K/V share); under
        # DTensor every block's batched product pays a strategy search
        heads = sharding.split_placements(q, (0, 2))
        out = sharding.local_region(flash, heads, q, k, v).reshape(b, s, h, dh)

    out = out.reshape(b, s, h * dh) @ params["wo"].to(x.dtype).reshape(h * dh, d)
    return out, new_cache


def _rope_heads(x, positions, theta):
    """x: (B, S, H, dh), positions: (B, S) or (S,)."""
    if positions.ndim == 1:
        positions = positions[None, :]
    return apply_rope(x.transpose(1, 2), positions[:, None, :], theta).transpose(1, 2)


def init_kv_cache(cfg, batch: int, max_len: int, n_layers=None, dtype=torch.bfloat16,
                  device=None):
    """KV cache; stacked (L-major) when n_layers is given.

    Logical axes: ("layers", "batch", "cache_seq", "kv_heads", "head_dim").
    """
    kv, dh = cfg.n_kv_heads, cfg.d_head
    lead = () if n_layers is None else (n_layers,)
    return {
        "k": torch.zeros((*lead, batch, max_len, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((*lead, batch, max_len, kv, dh), dtype=dtype, device=device),
    }


KV_CACHE_AXES = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
