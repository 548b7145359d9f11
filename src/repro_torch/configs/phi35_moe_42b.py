"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE].

32L d_model=4096 32H (GQA kv=8, d_head=128) per-expert d_ff=6400,
MoE 16e top-2, vocab=32064.

EP: 16 experts / 16 model ranks = exactly 1 expert per rank — the cleanest
expert-parallel layout (shard_map manual over "model", combine = one
all-reduce per layer).  Attention: 32 heads shard (layout B for K/V).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=6400,
        vocab_size=32064,
        n_experts=16,
        moe_top_k=2,
        moe_capacity_factor=1.25,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi35moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab_size=257,
        n_experts=4,
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
