"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8, d_head=128) d_ff=9216 vocab=256000.
The 256k vocabulary makes the logits head the dominant memory term —
exactly the workload the chunked-CE path exists for.

TP: 24 heads / 8 kv not 16-divisible -> attention replicates on (16,16)
(the (32,8) mesh restores it: 24 % 8 == 0 — §Perf lever).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=9216,
        vocab_size=256000,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=6,
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab_size=512,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
