"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5, d_head=64) d_ff=5504 vocab=32001,
ssm_state=16.  Hymba runs sliding-window attention in all but 3 global
layers (first / middle / last) — which makes it (with mamba2) one of the
two long_500k-eligible architectures.

TP notes (16-wide "model" axis): 25 heads / 5 kv heads / 25 ssm heads are
not 16-divisible -> attention & SSM weights replicate (divisibility filter);
d_ff = 5504 = 16 x 344 shards.  The decode KV cache seq-shards instead
(cache_seq override).  See DESIGN.md §Arch-applicability.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_heads=25,
        ssm_head_dim=64,
        ssm_state=16,
        ssm_groups=1,
        ssm_chunk=256,
        sliding_window=1024,
        global_layers=(0, 15, 31),
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=5,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab_size=257,
        ssm_heads=5,
        ssm_head_dim=16,
        ssm_state=8,
        ssm_groups=1,
        ssm_chunk=8,
        sliding_window=8,
        global_layers=(0,),
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
