"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0].

40L d_model=4096 32H (GQA kv=8, d_head=128) d_ff=12800 vocab=49155.

TP: 32 heads divide 16 but kv=8 does not -> GQA layout B (K/V repeated to
32 heads inside attention, flat head axis shards).  Decode cache keeps the
8 kv heads and seq-shards over "model".
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12800,
        vocab_size=49155,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab_size=259,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
