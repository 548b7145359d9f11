"""The language model — the port of ``repro.models.lm``.

``LM`` is an ``nn.Module``: embed -> blocks in an ``nn.ModuleList`` ->
final norm -> head, with the JAX tree's names (``embed``, ``layers``,
``final_norm``, ``lm_head``; the VLM's ``img_proj``; the audio family's
``audio_proj``, ``enc_pos``, ``encoder`` and ``enc_norm``).
``lm_forward``, ``head_logits``, ``chunked_ce_loss``, ``train_loss``,
``prefill`` and ``decode_step`` keep the JAX signatures with the model in
place of the value tree.  All ten architectures' families are ported:
dense, MoE, SSM (Mamba-2), hybrid (Hymba), VLM (the patch embeddings'
projection spliced in front of the tokens) and audio (whisper: an
encoder over frame embeddings, cross-attended by every decoder layer).

Cache contract: ``{"index": int32 scalar or (B,) per-row tensor,
"layers": <stacked per-layer tree>}``, the JAX package's layout: every
leaf leads with the layer axis — ``{"k", "v"}`` of ``(L, B, Smax, KV,
dh)`` for the attention families, the SSM state and conv inputs
(``ssm.init_ssm_cache``) for ``ssm``, ``{"attn": ..., "ssm": ...}`` for
``hybrid``, and ``{"self": {k, v}, "cross": {k, v}}`` for audio, the
cross leaves ``(L, B, encoder_len, KV, dh)``.  A per-row index lets rows
sit at different cache depths — the slot-local positions
continuous-batching serving needs.  Unlike the JAX functions,
``prefill`` and ``decode_step`` write the layer buffers in place and
return them in the new cache (with a new index): the caller's old cache
dict shares them.

In train mode each block runs under a non-reentrant
``torch.utils.checkpoint`` when ``cfg.remat_policy`` is ``"nothing"`` or
``"dots"`` (JAX's ``_remat``): its activations are recomputed in the
backward pass, which changes no value.  No op of the loss draws a random
number, so the checkpoints keep no generator state
(``preserve_rng_state=False``): saving and setting the card's generator
would read it from the host, which a captured train step cannot do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    active_mesh,
    local_extent,
    local_region,
    reduce_into,
    shard,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import apply_norm
from repro_torch.models.layers import matmul_f32, param
from repro_torch.samplers.engine import resolve_device

STACKS = ("layers", "encoder")  # module lists whose leaves JAX stacks on a layer axis


def _proj_params(gen, d_in: int, cfg, device=None) -> nn.ParameterDict:
    """A frontend stub's projection (``img_proj``, ``audio_proj``)."""
    d, dt = cfg.d_model, cfg.param_dtype
    return nn.ParameterDict({
        "w": param(gen, (d_in, d), (None, "embed_tp"), dt, device=device),
        "b": param(gen, (d,), ("embed",), dt, mode="zeros", device=device),
    })


class LM(nn.Module):
    """One architecture's parameters.  ``gen`` draws them by the JAX init
    rule (``layers.param``); ``gen=None`` leaves them uninitialised on
    ``device`` for the weight converter to fill."""

    def __init__(self, cfg, gen: torch.Generator | None = None, device=None):
        super().__init__()
        d, vp, dt = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
        self.cfg = cfg
        self.embed = param(gen, (vp, d), ("vocab", "embed"), dt, scale=1.0, device=device)
        kind = "encoder_cross" if cfg.is_encdec else None
        self.layers = nn.ModuleList(
            blocks.init_block(gen, cfg, kind=kind, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = blocks._norm_params(gen, cfg, device)
        self.lm_head = param(gen, (d, vp), ("embed", "vocab"), dt, device=device)
        if cfg.family == "vlm":
            self.img_proj = _proj_params(gen, cfg.image_embed_dim, cfg, device)
        if cfg.is_encdec:  # audio / whisper
            self.audio_proj = _proj_params(gen, cfg.frame_dim, cfg, device)
            self.enc_pos = param(gen, (cfg.encoder_len, d), ("seq", "embed_tp"), dt, scale=0.02,
                                 device=device)
            self.encoder = nn.ModuleList(
                blocks.init_block(gen, cfg, kind="encoder", device=device)
                for _ in range(cfg.n_encoder_layers)
            )
            self.enc_norm = blocks._norm_params(gen, cfg, device)
        # logical sharding axes by parameter name; a stacked leaf gains the
        # "layers" axis, as in the JAX tree
        self.param_axes = {
            name: (("layers",) if name.split(".")[0] in STACKS else ()) + p.logical_axes
            for name, p in self.named_parameters()
        }

    def forward(self, batch, *, mode: str, cache=None):
        return lm_forward(self, self.cfg, batch, mode=mode, cache=cache)


def init_lm(cfg, seed: int = 0, device=None) -> LM:
    """The model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    return LM(cfg, torch.Generator(device=dev).manual_seed(int(seed)))


def abstract_params(cfg, device="meta"):
    """(model, axes tree) with nothing allocated: the model's parameters
    are uninitialised on ``device``, so fake under the dry run's
    ``FakeTensorMode`` and ``meta`` tensors otherwise (the JAX package's
    ``jax.eval_shape`` of the init)."""
    model = LM(cfg, device=device)
    return model, model.param_axes


# --- caches ------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (a cache
    tree), as ``jax.tree.map`` maps it."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer_cache(cfg, batch: int, max_len: int, device=None):
    L, dt = cfg.n_layers, cfg.cache_dtype
    if cfg.family == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, n_layers=L, dtype=dt, device=device)
    if cfg.family == "hybrid":
        return {
            "attn": attn_mod.init_kv_cache(cfg, batch, max_len, L, dt, device),
            "ssm": ssm_mod.init_ssm_cache(cfg, batch, n_layers=L, dtype=dt, device=device),
        }
    if cfg.is_encdec:
        return {
            "self": attn_mod.init_kv_cache(cfg, batch, max_len, L, dt, device),
            "cross": attn_mod.init_kv_cache(cfg, batch, cfg.encoder_len, L, dt, device),
        }
    return attn_mod.init_kv_cache(cfg, batch, max_len, L, dt, device)


def init_cache(cfg, batch: int, max_len: int, device=None):
    """The zeroed cache; under a mesh (``sharding.use_mesh``) each layer
    leaf is a DTensor placed by ``cache_axes`` under the active rules
    (the configs shard ``cache_seq``), the index a plain tensor."""
    dev = resolve_device(device)
    layers = _layer_cache(cfg, batch, max_len, dev)
    if active_mesh() is not None:
        layers = tree_map(lambda t, axes: shard(t, axes), layers, cache_axes(cfg)["layers"])
    return {"index": torch.zeros((), dtype=torch.int32, device=dev), "layers": layers}


def abstract_cache(cfg, batch: int, max_len: int, device="meta"):
    """``init_cache`` with nothing allocated (see ``abstract_params``)."""
    return init_cache(cfg, batch, max_len, device)


_KV_AXES = {"k": attn_mod.KV_CACHE_AXES, "v": attn_mod.KV_CACHE_AXES}
_SSM_AXES = {
    "state": ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"),
    "conv_x": ("layers", "batch", "conv", "ssm_heads", "head_dim"),
    "conv_B": ("layers", "batch", "conv", None, "ssm_state"),
    "conv_C": ("layers", "batch", "conv", None, "ssm_state"),
}


def cache_axes(cfg):
    """The cache tree's logical axes, leaf for leaf."""
    if cfg.family == "ssm":
        layers = dict(_SSM_AXES)
    elif cfg.family == "hybrid":
        layers = {"attn": dict(_KV_AXES), "ssm": dict(_SSM_AXES)}
    elif cfg.is_encdec:
        layers = {"self": dict(_KV_AXES), "cross": dict(_KV_AXES)}
    else:
        layers = dict(_KV_AXES)
    return {"index": (), "layers": layers}


# --- layer metadata (per-layer heterogeneity) ----------------------------------


def layer_metas(cfg):
    """Per-layer flags ({"is_global": (L,) bool}), or None if homogeneous."""
    if cfg.sliding_window > 0 and cfg.global_layers:
        is_global = np.zeros((cfg.n_layers,), dtype=bool)
        for g in cfg.global_layers:
            is_global[g] = True
        return {"is_global": is_global}
    return None


# --- forward -------------------------------------------------------------------


def _remat(cfg, mode: str) -> bool:
    """Whether train mode recomputes each block in the backward pass."""
    return mode == "train" and cfg.remat_policy in ("nothing", "dots") and (
        torch.is_grad_enabled())


def _stack_apply(stack, x, cfg, *, mode: str, positions, cache_layers=None, cache_index=None,
                 metas=None, enc_out=None, remat: bool = False):
    """The blocks of ``stack`` in order; returns (x, the summed aux loss)."""
    aux = 0.0
    for i, layer in enumerate(stack):
        cl = None if cache_layers is None else tree_map(lambda t: t[i], cache_layers)
        meta = None if metas is None else {n: bool(v[i]) for n, v in metas.items()}
        kw = dict(mode=mode, positions=positions, cache=cl, cache_index=cache_index, meta=meta,
                  enc_out=enc_out)
        if remat:
            x, _, a = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False, **kw)
        else:
            x, _, a = layer(x, **kw)
        aux = aux + a
    return x, aux


def _stack_output(x, cfg):
    """The last block's output (under a mesh, a partial sum over the
    dimensions that split its last product) reduced into the residual
    layout, as every other block's output is reduced at the next block's
    entry and as JAX's scan reduces each into its carry: one all-reduce,
    whose gradient comes back in the same layout."""
    seq_axis = "seq_sp" if cfg.seq_shard else "seq"
    return reduce_into(x, ("batch", seq_axis, "embed"))


def _encode_audio(model: LM, cfg, frames, remat: bool = False):
    """Stub frontend: precomputed mel-frame features -> encoder stack."""
    cdt = cfg.compute_dtype
    w, b = model.audio_proj["w"], model.audio_proj["b"]
    x = frames.to(cdt) @ w.to(cdt) + b
    x = x + model.enc_pos.to(cdt)[None]
    pos = torch.arange(cfg.encoder_len, device=x.device)
    x, _ = _stack_apply(model.encoder, x, cfg, mode="full", positions=pos, remat=remat)
    return apply_norm(model.enc_norm, _stack_output(x, cfg), cfg)


def _embed_tokens(table, cfg, tokens):
    """The tokens' rows of the embedding table in the compute dtype, laid
    out ("batch", seq, "embed").  Where a mesh splits the table's rows
    (the "vocab" rule), the lookup is vocab-parallel, in a local region:
    each rank takes the rows of its own vocabulary range for the tokens
    that fall in it and zeros for the rest, and one sum over the
    dimensions that split the table (an all-reduce, or a reduce-scatter
    onto ``seq_sp``) gives the rows.  The table never crosses a link and
    its gradient lands on each rank's shard; each output element has one
    non-zero term, so the sum equals the lookup bit for bit."""
    from torch.distributed.tensor import Partial, Replicate

    axes = ("batch", "seq_sp" if cfg.seq_shard else "seq", "embed")
    split = {i for i, p in enumerate(getattr(table, "placements", ())) if p.is_shard(0)}
    if not split:
        return shard(table[tokens].to(cfg.compute_dtype), axes)
    mesh, dtype = table.device_mesh, cfg.compute_dtype
    (n, _), (lo, _) = local_extent(table.shape, mesh, table.placements)
    tok = shard(tokens, ("batch", None))  # each rank's rows of the batch
    tok = tok.redistribute(mesh, [Replicate() if i in split else p
                                  for i, p in enumerate(tok.placements)])
    out_pl = [Partial() if i in split else p for i, p in enumerate(tok.placements)]

    def lookup(t, ids):
        ids = ids - lo
        inside = (ids >= 0) & (ids < n)
        return torch.where(inside[..., None], t[ids.clamp(0, n - 1)].to(dtype), 0)

    return shard(local_region(lookup, None, table, tok, out_placements=out_pl), axes)


def lm_forward(model: LM, cfg, batch, *, mode: str, cache=None):
    """Backbone forward: returns (hidden (B,S,d), new_cache, aux_loss);
    the auxiliary loss is the blocks' sum (the MoE routers' losses; 0.0
    for the other families).

    batch: {"tokens": (B, S) int} plus family extras ("image_embeds"
    (B, n_image_tokens, image_embed_dim) for vlm, "frames" (B,
    encoder_len, frame_dim) for audio; both unused in decode).
    mode: "train" | "prefill" | "decode".
    """
    tokens = batch["tokens"]
    b, s_tok = tokens.shape
    index = None if cache is None else cache["index"]
    dev = model.embed.device
    remat = _remat(cfg, mode)

    enc_out = None
    if cfg.is_encdec and mode != "decode":
        enc_out = _encode_audio(model, cfg, batch["frames"], remat)

    x = _embed_tokens(model.embed, cfg, tokens)
    if cfg.family == "vlm" and mode != "decode":
        cdt = cfg.compute_dtype
        w, bias = model.img_proj["w"], model.img_proj["b"]
        img = batch["image_embeds"].to(cdt) @ w.to(cdt) + bias
        x = torch.cat([img, x], dim=1)

    s_total = x.shape[1]
    if mode == "decode":
        # scalar index -> (s_tok,) positions; per-row (B,) index -> (B,
        # s_tok), so rows at different cache depths decode in one batch
        positions = index[..., None] + torch.arange(s_tok, device=dev)
    else:
        positions = torch.arange(s_total, device=dev)

    x, aux = _stack_apply(
        model.layers, x, cfg, mode="decode" if mode == "decode" else "full",
        positions=positions, cache_layers=None if cache is None else cache["layers"],
        cache_index=index, metas=layer_metas(cfg), enc_out=enc_out, remat=remat)
    x = apply_norm(model.final_norm, _stack_output(x, cfg), cfg)

    new_cache = None
    if cache is not None:
        new_index = index + (s_tok if mode == "decode" else s_total)
        new_cache = {"index": new_index, "layers": cache["layers"]}
    return x, new_cache, aux


def head_logits(model: LM, cfg, hidden):
    """hidden (..., d) -> masked float32 logits (..., padded_vocab)."""
    w = model.lm_head.to(cfg.compute_dtype)
    lead = hidden.shape[:-1]
    logits = matmul_f32(hidden.reshape(-1, hidden.shape[-1]), w).reshape(*lead, -1)
    logits = shard(logits, ("batch", "seq", "vocab"))
    if cfg.padded_vocab != cfg.vocab_size:
        # a masked fill over a column mask, not a slice assignment: DTensor
        # has no sharding strategy for the slice's aten.fill_.Tensor
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits.masked_fill_(col >= cfg.vocab_size, -1e30)
    return logits


def _vocab_parallel_terms(logits, lab):
    """(logsumexp, the label's logit) of logits split over the vocabulary,
    each from the rank's own columns: the row maximum (no gradient: the
    logsumexp does not depend on it) a max over ranks, the sum of
    ``exp(x - max)`` a partial sum reduced once, and the label's logit a
    masked partial sum with one non-zero term, so it equals the gather
    bit for bit.  The (B, chunk, V) logits are never gathered, and their
    gradient (softmax less the one-hot) stays on each rank's columns."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, last = logits.device_mesh, logits.ndim - 1
    split = {i for i, p in enumerate(logits.placements) if p.is_shard(last)}
    (*_, n), (*_, lo) = local_extent(logits.shape, mesh, logits.placements)
    rows = [Replicate() if i in split else p for i, p in enumerate(logits.placements)]

    def partial(op):
        return [Partial(op) if i in split else p for i, p in enumerate(logits.placements)]

    def row_max(x):
        return x.detach().amax(dim=-1)

    def terms(x, m, ids):
        ids = ids.clamp_min(0) - lo
        inside = (ids >= 0) & (ids < n)
        ll = torch.take_along_dim(x, ids.clamp(0, n - 1)[..., None].long(), dim=-1)[..., 0]
        return torch.exp(x - m[..., None]).sum(dim=-1), torch.where(inside, ll, 0)

    m = local_region(row_max, None, logits, out_placements=partial("max"))
    m = m.redistribute(mesh, rows)
    sumexp, ll = local_region(terms, None, logits, m, shard(lab, ("batch", "seq")),
                              out_placements=partial("sum"))
    return torch.log(sumexp.redistribute(mesh, rows)) + m, ll.redistribute(mesh, rows)


def _chunk_terms(model: LM, cfg, h, lab):
    """One chunk's (nll sum, z sum, count): float32 logits, their
    logsumexp, the label's logit; negative labels masked out.  Where a
    mesh splits the vocabulary, the terms are vocab-parallel."""
    logits = head_logits(model, cfg, h)
    if any(p.is_shard(logits.ndim - 1) for p in getattr(logits, "placements", ())):
        logz, ll = _vocab_parallel_terms(logits, lab)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, lab.clamp_min(0)[..., None].long(), dim=-1)[..., 0]
    mask = (lab >= 0).float()
    nll = torch.sum((logz - ll) * mask)
    zl = torch.sum(torch.square(logz) * mask) if cfg.z_loss > 0 else torch.zeros_like(nll)
    return nll, zl, torch.sum(mask)


def chunked_ce_loss(model: LM, cfg, hidden, labels):
    """Cross-entropy over seq chunks; logits never fully materialised.

    labels: (B, S) int with negative values masked out.  The chunk is the
    largest divisor of S at most ``cfg.logits_chunk``; each chunk runs
    under a non-reentrant checkpoint when gradients are recorded, so the
    backward pass recomputes its logits and peak memory holds a single
    (B, chunk, V) float32 block, as ``jax.checkpoint`` does.  Returns
    (loss, count): the mean over unmasked labels plus ``z_loss`` times
    the mean squared logsumexp, and the number of unmasked labels.
    """
    b, s, d = hidden.shape
    c = min(cfg.logits_chunk, s)
    while s % c:
        c -= 1
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    loss_sum, z_sum, count = zero, zero, zero
    for i in range(s // c):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            nll, zl, n = checkpoint(_chunk_terms, model, cfg, h, lab, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            nll, zl, n = _chunk_terms(model, cfg, h, lab)
        loss_sum, z_sum, count = loss_sum + nll, z_sum + zl, count + n
    denom = torch.clamp_min(count, 1.0)
    return loss_sum / denom + cfg.z_loss * z_sum / denom, count


def train_loss(model: LM, cfg, batch):
    """Scalar training loss (+ metrics dict: ``ce_loss``, ``aux_loss``,
    ``tokens``, float32 scalars).  VLM image positions carry no labels;
    the MoE adds ``aux_loss_weight`` times the routers' loss."""
    hidden, _, aux = lm_forward(model, cfg, batch, mode="train")
    labels = batch["labels"]
    if cfg.family == "vlm":
        pad = torch.full((labels.shape[0], cfg.n_image_tokens), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss, count = chunked_ce_loss(model, cfg, hidden, labels)
    # every family but the MoE sums no router loss: a Python 0.0, filled
    # on the card (a copy from the host cannot be captured)
    aux = (torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
           if isinstance(aux, torch.Tensor)
           else torch.full((), np.float32(aux), dtype=torch.float32, device=loss.device))
    total = loss
    if cfg.family == "moe":
        total = total + cfg.aux_loss_weight * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": count}


# --- serving steps -------------------------------------------------------------


@torch.no_grad()
def prefill(model: LM, cfg, batch, cache):
    """Run the prompt through the stack, fill the cache, return last
    logits.  Serving records no graph, whether or not the weights are
    trainable (the cache writes are in place)."""
    hidden, new_cache, _ = lm_forward(model, cfg, batch, mode="prefill", cache=cache)
    logits = head_logits(model, cfg, hidden[:, -1:, :])[:, 0]
    return logits, new_cache


@torch.no_grad()
def decode_step(model: LM, cfg, tokens, cache):
    """One decode step: tokens (B, 1) + cache -> (logits (B, V), cache');
    no graph is recorded."""
    hidden, new_cache, _ = lm_forward(model, cfg, {"tokens": tokens}, mode="decode",
                                      cache=cache)
    logits = head_logits(model, cfg, hidden[:, -1:, :])[:, 0]
    return logits, new_cache
