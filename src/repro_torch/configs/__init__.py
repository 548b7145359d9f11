"""Architecture registry and assigned input shapes — the port of
``repro.configs``.

Each ``<arch>.py`` exports ``config()`` (the exact assigned
configuration) and ``smoke_config()`` (a reduced same-family variant for
CPU tests); they are data only, copied from the JAX package.
``batch_specs`` and ``cache_specs`` give the dry run
(``repro_torch.launch.dryrun``) its inputs without allocating them.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "hymba_1p5b",
    "phi3_vision_4p2b",
    "mamba2_1p3b",
    "phi3_medium_14b",
    "granite3_8b",
    "minitron_4b",
    "granite_34b",
    "whisper_large_v3",
    "phi35_moe_42b",
    "qwen3_moe_30b",
)

# canonical assignment names -> module ids
ARCH_ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "mamba2-1.3b": "mamba2_1p3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "granite-3-8b": "granite3_8b",
    "minitron-4b": "minitron_4b",
    "granite-34b": "granite_34b",
    "whisper-large-v3": "whisper_large_v3",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
}


def _module(name: str):
    mod_id = ARCH_ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{mod_id}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


# --- assigned shapes -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable, reason).  long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention (SSM/hybrid-SWA); "
            f"{cfg.name} is pure full-attention — skipped per the assignment"
        )
    return True, ""


def assigned_cells():
    """All (arch, shape) baseline cells, with applicability flags."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, reason = shape_applicable(cfg, shape)
            cells.append((arch, shape.name, ok, reason))
    return cells


# --- dry-run input specs ---------------------------------------------------------


def _spec(shape, dtype, device):
    """A tensor that allocates nothing: fake under the dry run's
    ``FakeTensorMode``, else on ``device`` (``"meta"`` by default)."""
    import torch

    return torch.empty(shape, dtype=getattr(torch, dtype), device=device)


def batch_specs(cfg, shape: ShapeSpec, device="meta"):
    """The data batch of one step as shape-and-dtype stand-ins (the JAX
    package's ``jax.ShapeDtypeStruct`` tree; its int32 tokens and labels
    are int64 here, as the port's batches are)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":  # one new token against a seq_len-deep cache
        return {"tokens": _spec((b, 1), "int64", device)}
    if cfg.family == "vlm":
        s -= cfg.n_image_tokens
    batch = {"tokens": _spec((b, s), "int64", device)}
    if shape.kind == "train":
        batch["labels"] = _spec((b, s), "int64", device)
    if cfg.family == "vlm":
        batch["image_embeds"] = _spec((b, cfg.n_image_tokens, cfg.image_embed_dim), "bfloat16",
                                      device)
    elif cfg.is_encdec:
        batch["frames"] = _spec((b, cfg.encoder_len, cfg.frame_dim), "bfloat16", device)
    return batch


def cache_specs(cfg, shape: ShapeSpec, device="meta"):
    """The cache of a prefill or decode cell, allocating nothing
    (``lm.abstract_cache``); None for a train cell."""
    from repro_torch.models import lm

    if shape.kind == "train":
        return None
    return lm.abstract_cache(cfg, shape.global_batch, shape.seq_len, device)
