"""whisper-large-v3 [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

32L (decoder) + 32L (encoder) d_model=1280 20H (MHA kv=20, d_head=64)
d_ff=5120 vocab=51866.  Per the assignment the mel/conv frontend is a
STUB: ``input_specs`` provides precomputed frame embeddings
(encoder_len=1500 x frame_dim=128); the encoder is bidirectional with
learned positions, the decoder has causal self-attn + cross-attn.

Backbone adaptation notes (DESIGN.md): decoder self-attention uses RoPE
(the original uses learned absolute positions — backbone-only spec);
pre-LN layernorm, GELU, ungated MLP as in the original.

TP: 20 heads not 16-divisible -> attention replicates on (16,16)
(a (64,4) mesh restores it: 20 % 4 == 0); d_ff = 5120 = 16 x 320 shards.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_head=64,
        d_ff=5120,
        vocab_size=51866,
        act="gelu",
        mlp_gated=False,
        norm="layernorm",
        n_encoder_layers=32,
        encoder_len=1500,
        frame_dim=128,
        sharding_overrides=(("cache_seq", ("pod", "data", "model")),),
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=258,
        act="gelu",
        mlp_gated=False,
        norm="layernorm",
        n_encoder_layers=2,
        encoder_len=12,
        frame_dim=16,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
