"""The language model's serving half — the port of ``repro.models.lm``.

``LM`` is an ``nn.Module``: embed -> blocks in an ``nn.ModuleList`` ->
final norm -> head, with the JAX tree's names (``embed``, ``layers``,
``final_norm``, ``lm_head``).  ``lm_forward``, ``head_logits``,
``prefill`` and ``decode_step`` keep the JAX signatures with the model
in place of the value tree.  The dense family is ported; the MoE, SSM,
hybrid, VLM and audio families raise ``NotImplementedError``, and the
training half (``chunked_ce_loss``, ``train_loss``) waits for the
training slice (ROADMAP.md queue 1 item 10).

Cache contract: ``{"index": int32 scalar or (B,) per-row tensor,
"layers": {"k", "v"}}`` with stacked ``(L, B, Smax, KV, dh)`` leaves, the
JAX package's layout.  A per-row index lets rows sit at different cache
depths — the slot-local positions continuous-batching serving needs.
Unlike the JAX functions, ``prefill`` and ``decode_step`` write the
layer buffers in place and return them in the new cache (with a new
index): the caller's old cache dict shares them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.blocks import apply_norm
from repro_torch.models.layers import matmul_f32, param
from repro_torch.samplers.engine import resolve_device

# the families still to port, and where (ROADMAP.md queue 1 item 10)
FAMILIES_NOT_PORTED = {
    "moe": "queue 1 item 10b (the MoE family)",
    "ssm": "queue 1 item 10c (the SSM and hybrid families)",
    "hybrid": "queue 1 item 10c (the SSM and hybrid families)",
    "vlm": "queue 1 item 10d (the VLM family)",
    "audio": "queue 1 item 10e (the audio family)",
}


def _check_family(cfg) -> None:
    family = "audio" if cfg.is_encdec else cfg.family
    if family in FAMILIES_NOT_PORTED:
        raise NotImplementedError(
            f"the {family!r} family ({cfg.name}) is not ported yet: ROADMAP.md "
            f"{FAMILIES_NOT_PORTED[family]}"
        )


class LM(nn.Module):
    """One architecture's parameters.  ``gen`` draws them by the JAX init
    rule (``layers.param``); ``gen=None`` leaves them uninitialised on
    ``device`` for the weight converter to fill."""

    def __init__(self, cfg, gen: torch.Generator | None = None, device=None):
        super().__init__()
        _check_family(cfg)
        d, vp, dt = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
        self.cfg = cfg
        self.embed = param(gen, (vp, d), ("vocab", "embed"), dt, scale=1.0, device=device)
        self.layers = nn.ModuleList(
            blocks.init_block(gen, cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = blocks._norm_params(gen, cfg, device)
        self.lm_head = param(gen, (d, vp), ("embed", "vocab"), dt, device=device)
        # logical sharding axes by parameter name; a block leaf's gain the
        # stacked "layers" axis, as in the JAX tree
        self.param_axes = {
            name: (("layers",) if name.startswith("layers.") else ()) + p.logical_axes
            for name, p in self.named_parameters()
        }

    def forward(self, batch, *, mode: str, cache=None):
        return lm_forward(self, self.cfg, batch, mode=mode, cache=cache)


def init_lm(cfg, seed: int = 0, device=None) -> LM:
    """The model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    return LM(cfg, torch.Generator(device=dev).manual_seed(int(seed)))


# --- caches ------------------------------------------------------------------


def _layer_cache(cfg, batch: int, max_len: int, device=None):
    _check_family(cfg)
    return attn_mod.init_kv_cache(cfg, batch, max_len, cfg.n_layers, cfg.cache_dtype, device)


def init_cache(cfg, batch: int, max_len: int, device=None):
    dev = resolve_device(device)
    return {
        "index": torch.zeros((), dtype=torch.int32, device=dev),
        "layers": _layer_cache(cfg, batch, max_len, dev),
    }


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


def lm_forward(model: LM, cfg, batch, *, mode: str, cache=None):
    """Backbone forward: returns (hidden (B,S,d), new_cache, aux_loss);
    the auxiliary loss is the blocks' sum (0.0 for the dense family).

    batch: {"tokens": (B, S) int}.  mode: "prefill" or "decode" ("train"
    runs the prefill path without a cache).
    """
    tokens = batch["tokens"]
    b, s_tok = tokens.shape
    index = None if cache is None else cache["index"]
    dev = model.embed.device

    x = model.embed[tokens].to(cfg.compute_dtype)
    if mode == "decode":
        # scalar index -> (s_tok,) positions; per-row (B,) index -> (B,
        # s_tok), so rows at different cache depths decode in one batch
        positions = index[..., None] + torch.arange(s_tok, device=dev)
    else:
        positions = torch.arange(s_tok, device=dev)

    metas = layer_metas(cfg)
    aux = 0.0
    for i, layer in enumerate(model.layers):
        cl = None if cache is None else {n: t[i] for n, t in cache["layers"].items()}
        meta = None if metas is None else {n: bool(v[i]) for n, v in metas.items()}
        x, _, a = layer(
            x, mode="decode" if mode == "decode" else "full", positions=positions,
            cache=cl, cache_index=index, meta=meta,
        )
        aux = aux + a
    x = apply_norm(model.final_norm, x, cfg)

    new_cache = None
    if cache is not None:
        new_cache = {"index": index + s_tok, "layers": cache["layers"]}
    return x, new_cache, aux


def head_logits(model: LM, cfg, hidden):
    """hidden (..., d) -> masked float32 logits (..., padded_vocab)."""
    w = model.lm_head.to(cfg.compute_dtype)
    lead = hidden.shape[:-1]
    logits = matmul_f32(hidden.reshape(-1, hidden.shape[-1]), w).reshape(*lead, -1)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# --- serving steps -------------------------------------------------------------


def prefill(model: LM, cfg, batch, cache):
    """Run the prompt through the stack, fill the cache, return last logits."""
    hidden, new_cache, _ = lm_forward(model, cfg, batch, mode="prefill", cache=cache)
    logits = head_logits(model, cfg, hidden[:, -1:, :])[:, 0]
    return logits, new_cache


def decode_step(model: LM, cfg, tokens, cache):
    """One decode step: tokens (B, 1) + cache -> (logits (B, V), cache')."""
    hidden, new_cache, _ = lm_forward(model, cfg, {"tokens": tokens}, mode="decode",
                                      cache=cache)
    logits = head_logits(model, cfg, hidden[:, -1:, :])[:, 0]
    return logits, new_cache
