"""granite-34b [dense] — llama-arch code model, MQA [arXiv:2405.04324].

88L d_model=6144 48H (MQA kv=1, d_head=128) d_ff=24576 vocab=49152.
The deepest assigned arch — the scan-over-layers requirement exists for
this config (88 unrolled layers x 512 fake devices would not compile on
one CPU).

TP: 48 heads -> layout B (MQA K/V broadcast to 48 heads); the single kv
head replicates in the cache, which therefore seq-shards.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",
        mlp_gated=False,   # GPT-BigCode style FFN (2 mats) -> 34B total
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite34-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
