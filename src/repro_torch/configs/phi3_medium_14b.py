"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10, d_head=128) d_ff=17920 vocab=100352.

TP: 40 heads / 10 kv heads are not 16-divisible -> attention weights
replicate on the 16-wide model axis (d_ff = 17920 = 16 x 1120 shards);
an alternative (32,8) mesh restores attention TP — a §Perf lever.
Decode cache seq-shards (cache_seq override).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_head=128,
        d_ff=17920,
        vocab_size=100352,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3m-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=160,
        vocab_size=257,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
