"""Transformer, SSM, hybrid and MoE blocks — the port of
``repro.models.blocks``.

A block's parameters sit under the JAX tree's names (``ln1``, ``attn``,
``ln2``, ``mlp``, ``moe``, ``mamba``, ``branch_scale``) in a ``Block``, a
``ModuleDict`` of ``ParameterDict``s (``branch_scale`` is a parameter of
the block itself), so the weight converter maps leaf paths one to one.
``init_block`` / ``apply_block`` keep the JAX signatures.  The audio
family's ``encoder`` and ``encoder_cross`` kinds are not ported yet and
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import activation, layer_norm, param, rms_norm

KINDS = ("dense", "vlm", "moe", "ssm", "hybrid")

# the kinds still to port, and where (ROADMAP.md queue 1 item 10)
NOT_PORTED = {
    "encoder": "queue 1 item 10e (the audio family)",
    "encoder_cross": "queue 1 item 10e (the audio family)",
}


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not have yet."""
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"the {kind!r} block is not ported yet: ROADMAP.md {NOT_PORTED[kind]}"
        )
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _norm_params(gen, cfg, device=None) -> nn.ParameterDict:
    dt = cfg.param_dtype
    if cfg.norm == "layernorm":
        return nn.ParameterDict({
            "w": param(gen, (cfg.d_model,), ("embed",), dt, mode="ones", device=device),
            "b": param(gen, (cfg.d_model,), ("embed",), dt, mode="zeros", device=device),
        })
    return nn.ParameterDict({
        "w": param(gen, (cfg.d_model,), ("embed",), dt, mode="ones", device=device)
    })


def apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def init_mlp(gen, cfg, device=None) -> nn.ParameterDict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_gated:
        return nn.ParameterDict({
            "w_gate": param(gen, (d, f), ("embed", "ffn"), dt, device=device),
            "w_up": param(gen, (d, f), ("embed", "ffn"), dt, device=device),
            "w_down": param(gen, (f, d), ("ffn", "embed"), dt, device=device),
        })
    return nn.ParameterDict({
        "w_in": param(gen, (d, f), ("embed", "ffn"), dt, device=device),
        "w_out": param(gen, (f, d), ("ffn", "embed"), dt, device=device),
    })


def apply_mlp(p, x, cfg):
    act = activation(cfg.act)
    if cfg.mlp_gated:
        h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
        return h @ p["w_down"].to(x.dtype)
    h = act(x @ p["w_in"].to(x.dtype))
    return h @ p["w_out"].to(x.dtype)


class Block(nn.ModuleDict):
    """One layer's parameters under the JAX tree's names; calling it
    applies the layer (``apply_block``).  A parameter leaf of the block
    itself (``branch_scale``) is registered on it and read by name too."""

    def __init__(self, cfg, kind: str, params: dict):
        super().__init__({k: v for k, v in params.items() if not isinstance(v, nn.Parameter)})
        for name, value in params.items():
            if isinstance(value, nn.Parameter):
                self.register_parameter(name, value)
        self.cfg = cfg
        self.kind = kind

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def forward(self, x, **kw):
        return apply_block(self, x, self.cfg, kind=self.kind, **kw)


def init_block(gen, cfg, *, kind: str | None = None, device=None) -> Block:
    """kind overrides cfg.family; ``gen=None`` leaves the leaves
    uninitialised on ``device`` (the weight converter fills them)."""
    kind = kind or cfg.family
    check_kind(kind)
    p = {"ln1": _norm_params(gen, cfg, device)}
    if kind == "ssm":
        p["mamba"] = ssm_mod.init_mamba2(gen, cfg, device)
    elif kind == "hybrid":
        p["attn"] = attn_mod.init_attention(gen, cfg, device)
        p["mamba"] = ssm_mod.init_mamba2(gen, cfg, device)
        p["branch_scale"] = param(gen, (2,), (None,), torch.float32, mode="ones", device=device)
        p["ln2"] = _norm_params(gen, cfg, device)
        p["mlp"] = init_mlp(gen, cfg, device)
    else:
        p["attn"] = attn_mod.init_attention(gen, cfg, device)
        p["ln2"] = _norm_params(gen, cfg, device)
        if kind == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg, device)
        else:
            p["mlp"] = init_mlp(gen, cfg, device)
    return Block(cfg, kind, p)


def apply_block(
    p,
    x,
    cfg,
    *,
    mode: str,
    positions,
    cache=None,
    cache_index=None,
    meta=None,
    kind: str | None = None,
):
    """Returns (x, new_cache, aux_loss).

    Cache contract (per layer; the stacked index lives at the LM level),
    written in place:
      dense/moe/vlm : {"k", "v"}
      ssm           : {"state", "conv_x", "conv_B", "conv_C"}
      hybrid        : {"attn": {...}, "ssm": {...}}
    The auxiliary loss is the MoE router's (a float32 scalar), else 0.0.

    ``meta`` is this layer's slice of ``lm.layer_metas``: ``is_global``
    picks the layer's window when ``cfg.sliding_window`` is set."""
    kind = kind or cfg.family
    check_kind(kind)
    window = None
    if cfg.sliding_window > 0:
        window = cfg.sliding_window
        if meta is not None and meta.get("is_global", False):
            window = attn_mod.GLOBAL_WINDOW
    attn_mode = "decode" if mode == "decode" else "full"

    def mamba(h, ssm_cache):
        if mode == "decode":
            return ssm_mod.mamba2_decode(p["mamba"], h, cfg, ssm_cache)
        return ssm_mod.mamba2_full(p["mamba"], h, cfg, ssm_cache)

    h = apply_norm(p["ln1"], x, cfg)
    if kind == "ssm":
        out, new_cache = mamba(h, cache)
        return x + out, new_cache, 0.0

    if kind == "hybrid":
        a_out, a_cache = attn_mod.attention(
            p["attn"], h, cfg, positions=positions, mode=attn_mode,
            cache=None if cache is None else cache["attn"], cache_index=cache_index,
            window=window,
        )
        s_out, s_cache = mamba(h, None if cache is None else cache["ssm"])
        scale = p["branch_scale"].to(x.dtype)
        x = x + scale[0] * a_out + scale[1] * s_out
        x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
        return x, None if cache is None else {"attn": a_cache, "ssm": s_cache}, 0.0

    a_out, new_cache = attn_mod.attention(
        p["attn"],
        h,
        cfg,
        positions=positions,
        mode=attn_mode,
        cache=cache,
        cache_index=cache_index,
        window=window,
    )
    x = x + a_out
    h2 = apply_norm(p["ln2"], x, cfg)
    if kind == "moe":
        m_out, aux = moe_mod.moe_ffn(p["moe"], h2, cfg, activation(cfg.act))
        return x + m_out, new_cache, aux
    return x + apply_mlp(p["mlp"], h2, cfg), new_cache, 0.0
