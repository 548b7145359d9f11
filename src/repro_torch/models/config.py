"""Model configuration shared by all 10 assigned architectures — the
port of ``repro.models.config``, field for field.  The dtype properties
return ``torch.dtype``s."""

from __future__ import annotations

import dataclasses

import torch


def _dtype(name: str) -> torch.dtype:
    """A dtype name as numpy spells it ("bfloat16", "float32") -> torch."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    act: str = "silu"
    mlp_gated: bool = True
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    # attention windowing (hybrid long-context archs)
    sliding_window: int = 0          # 0 = all layers global
    global_layers: tuple = ()        # global layer ids when sliding_window > 0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_renormalize: bool = True
    aux_loss_weight: float = 0.01
    # SSM (Mamba-2)
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    frame_dim: int = 128             # stub mel-frame feature width
    # VLM
    n_image_tokens: int = 0
    image_embed_dim: int = 1024      # stub CLIP patch feature width
    # numerics / implementation
    dtype: str = "bfloat16"
    param_dtype_str: str = "bfloat16"
    cache_dtype_str: str = "bfloat16"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    attn_causal_skip: bool = False   # §Perf lever: static causal block skip
    remat_policy: str = "nothing"    # nothing | dots | none
    scan_layers: bool = True
    logits_chunk: int = 2048
    z_loss: float = 0.0
    # distribution levers
    seq_shard: bool = False          # SP: residual stream sharded over "model"
    vocab_pad_to: int = 256          # TP-friendly vocab padding (MaxText-style)
    sharding_overrides: tuple = ()   # ((logical_axis, mesh_axes), ...) rules patch
    train_microbatches: int = 4      # gradient-accumulation splits for train_4k

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def param_dtype(self) -> torch.dtype:
        return _dtype(self.param_dtype_str)

    @property
    def cache_dtype(self) -> torch.dtype:
        return _dtype(self.cache_dtype_str)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_mlp(self) -> bool:
        return self.d_ff > 0 and self.family != "moe"

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid with sliding windows)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window > 0
        )

    # ---- parameter counting (for MODEL_FLOPS = 6 N D) ----------------------

    def _attn_params(self) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        return d * h * dh + 2 * d * kv * dh + h * dh * d

    def _mlp_params(self) -> int:
        if self.d_ff == 0:
            return 0
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff

    def _ssm_params(self) -> int:
        if self.ssm_heads == 0:
            return 0
        d, h, p, n, g = (
            self.d_model,
            self.ssm_heads,
            self.ssm_head_dim,
            self.ssm_state,
            self.ssm_groups,
        )
        return 3 * d * h * p + 2 * d * g * n + d * h  # wx, wz, out, wB, wC, wdt

    def _moe_params(self) -> int:
        if self.n_experts == 0:
            return 0
        return self.n_experts * 3 * self.d_model * self.d_ff + self.d_model * self.n_experts

    def layer_params(self, active_only: bool = False) -> int:
        total = 0
        if self.has_attention:
            total += self._attn_params()
        if self.family in ("ssm", "hybrid"):
            total += self._ssm_params()
        if self.family == "moe":
            if active_only:
                total += self.moe_top_k * 3 * self.d_model * self.d_ff
            else:
                total += self._moe_params()
        else:
            total += self._mlp_params()
        return total

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count incl. embeddings."""
        n = self.n_layers * self.layer_params(active_only)
        n += self.n_encoder_layers * (self._attn_params() + self._mlp_params())
        if self.is_encdec:
            n += self.n_layers * self._attn_params()  # cross-attention
        embed = self.vocab_size * self.d_model
        n += embed if self.tie_embeddings else 2 * embed
        return n
