"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, d_head=128, QK-norm) per-expert d_ff=768,
MoE 128e top-8, vocab=151936.  Note h*d_head = 4096 != d_model — correct
per the real model (attention inner dim is wider than the residual).

EP: 128 experts / 16 ranks = 8 experts per rank.  The top-8 routing makes
this the most dispatch-intensive assigned arch — the natural
collective-bound hillclimb candidate.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        n_experts=128,
        moe_top_k=8,
        moe_capacity_factor=1.25,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=16,
        vocab_size=260,
        qk_norm=True,
        n_experts=8,
        moe_top_k=2,
        moe_capacity_factor=2.0,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
