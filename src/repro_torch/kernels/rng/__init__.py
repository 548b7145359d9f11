# Shared counter-based RNG: the host-side Threefry-2x32 in int64 torch
# ops, whose device twin is csrc/rng.cuh (traced into the fused MH kernel).

from repro_torch.kernels.rng.rng import (  # noqa: F401
    FLIP_SALT,
    MASK32,
    U_SALT,
    flips_at,
    key_words,
    raw_draw,
    site_index,
    step_key,
    threefry2x32,
    threefry2x32_device,
    threshold_u32,
    u32,
    uniform_at,
)
