"""mamba2-1.3b [ssm] — SSD state-space duality [arXiv:2405.21060].

48L d_model=2048 attention-free, ssm_state=128.  Standard Mamba-2 sizing:
expand=2 -> d_inner=4096 = 64 heads x head_dim 64; conv width 4; one
B/C group.  O(1) decode state makes every decode shape (incl. long_500k)
native.

TP: 64 ssm heads / 16 = 4 heads per model rank.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,
        vocab_size=50280,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_state=128,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=256,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        vocab_size=257,
        ssm_heads=4,
        ssm_head_dim=16,
        ssm_state=16,
        ssm_groups=1,
        ssm_chunk=8,
        dtype="float32",
        param_dtype_str="float32",
        cache_dtype_str="float32",
        logits_chunk=16,
        remat_policy="none",
    )
