"""Transformer blocks of the attention families — the port of
``repro.models.blocks``.

A block's parameters sit under the JAX tree's names (``ln1``, ``attn``,
``ln2``, ``mlp``) in a ``Block``, a ``ModuleDict`` of ``ParameterDict``s,
so the weight converter maps leaf paths one to one.  ``init_block`` /
``apply_block`` keep the JAX signatures.  The ``ssm``, ``hybrid``,
``moe``, ``encoder`` and ``encoder_cross`` kinds are not ported yet and
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import activation, layer_norm, param, rms_norm

ATTENTION_KINDS = ("dense", "vlm")

# the kinds still to port, and where (ROADMAP.md queue 1 item 10)
NOT_PORTED = {
    "moe": "queue 1 item 10b (the MoE family)",
    "ssm": "queue 1 item 10c (the SSM and hybrid families)",
    "hybrid": "queue 1 item 10c (the SSM and hybrid families)",
    "encoder": "queue 1 item 10e (the audio family)",
    "encoder_cross": "queue 1 item 10e (the audio family)",
}


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not have yet."""
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"the {kind!r} block is not ported yet: ROADMAP.md {NOT_PORTED[kind]}"
        )
    if kind not in ATTENTION_KINDS:
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
    applies the layer (``apply_block``)."""

    def __init__(self, cfg, kind: str, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.kind = kind

    def forward(self, x, **kw):
        return apply_block(self, x, self.cfg, kind=self.kind, **kw)


def init_block(gen, cfg, *, kind: str | None = None, device=None) -> Block:
    """kind overrides cfg.family; ``gen=None`` leaves the leaves
    uninitialised on ``device`` (the weight converter fills them)."""
    kind = kind or cfg.family
    check_kind(kind)
    return Block(cfg, kind, {
        "ln1": _norm_params(gen, cfg, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "ln2": _norm_params(gen, cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    })


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
    """Returns (x, new_cache, aux_loss); the cache is {"k", "v"}, and the
    auxiliary loss of the attention kinds is 0.0.

    ``meta`` is this layer's slice of ``lm.layer_metas``: ``is_global``
    picks the layer's window when ``cfg.sliding_window`` is set."""
    kind = kind or cfg.family
    check_kind(kind)
    window = None
    if cfg.sliding_window > 0:
        window = cfg.sliding_window
        if meta is not None and meta.get("is_global", False):
            window = attn_mod.GLOBAL_WINDOW

    h = apply_norm(p["ln1"], x, cfg)
    a_out, new_cache = attn_mod.attention(
        p["attn"],
        h,
        cfg,
        positions=positions,
        mode="decode" if mode == "decode" else "full",
        cache=cache,
        cache_index=cache_index,
        window=window,
    )
    x = x + a_out
    h2 = apply_norm(p["ln2"], x, cfg)
    x = x + apply_mlp(p["mlp"], h2, cfg)
    return x, new_cache, 0.0
