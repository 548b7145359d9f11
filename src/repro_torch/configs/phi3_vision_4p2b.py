"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP [hf:microsoft/Phi-3-vision].

32L d_model=3072 32H (MHA kv=32, d_head=96) d_ff=8192 vocab=32064.
The CLIP frontend is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings (n_image_tokens x image_embed_dim), spliced
in front of the text tokens; the MCMC sampler drives text decode only.

TP: 32 heads (and 32 kv) divide 16 -> full attention TP (layout A).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        n_image_tokens=576,       # 336px CLIP ViT-L/14 -> 24x24 patches
        image_embed_dim=1024,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=257,
        n_image_tokens=4,
        image_embed_dim=32,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        attn_block_q=8,
        attn_block_kv=8,
        logits_chunk=16,
        remat_policy="none",
    )
