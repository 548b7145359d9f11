"""Counter-based RNG — the host side of the in-kernel cipher.

The PyTorch counterpart of ``repro.kernels.rng``: Threefry-2x32 with 20
rounds, the step/site/salt derivation the fused MH kernel draws through,
and the uint32 threshold of a Bernoulli bit-plane.  ``csrc/rng.cuh``
holds the same cipher as ``__device__`` functions; the two are held
against each other on the card and against the Random123 known-answer
vectors.

Derivation contract (unchanged from the JAX package)::

    key words    (k0, k1) = key_words(chain_key)
    step fold    (s0, s1) = step_key(k0, k1, t)       # t = absolute step
    site draw    bits     = threefry2x32(s0, s1, site, salt)[0]

uint32 words are carried as int64 tensors masked to 32 bits: PyTorch has
no uint32 add, shift or compare on the CPU.  Every function here also
takes python ints and broadcasts its tensor arguments together.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Threefry-2x32 rotation schedule: rounds 4i..4i+3 use ROTATIONS[i % 2].
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Key-schedule parity constant (the 2x32 slice of the Threefish C240).
_PARITY = 0x1BD11BDA

# Operand-stream salts (second counter word).  FLIP planes occupy
# [FLIP_SALT, FLIP_SALT + 32); U_SALT lives far outside that window.
U_SALT = 0x554E4946  # "UNIF"
FLIP_SALT = 0x464C4950  # "FLIP"


def u32(x):
    """``x`` as uint32 values: a python int masked, or an int64 tensor."""
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One Threefry-2x32-20 block: counter (x0, x1) under key (k0, k1).

    Inputs broadcast together; the result is two int64 tensors (or python
    ints when every input is an int) holding uint32 words.
    """
    k0, k1, x0, x1 = u32(k0), u32(k1), u32(x0), u32(x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key_words(key):
    """The two uint32 key words of a key tensor of shape (..., 2)."""
    return key[..., 0], key[..., 1]


def step_key(k0, k1, t):
    """Fold absolute step ``t`` into the chain key (one cipher block)."""
    return threefry2x32(k0, k1, t, 0)


def raw_draw(s0, s1, site, salt: int):
    """One uint32 of stream ``salt`` at each ``site`` under a step key."""
    return threefry2x32(s0, s1, site, salt)[0]


def uniform_at(s0, s1, site) -> torch.Tensor:
    """u ~ U[0,1) at each ``site``: the top 24 bits of the U-stream draw,
    scaled by 2^-24 — exact in float32, so every executor agrees."""
    bits = raw_draw(s0, s1, site, U_SALT)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def threshold_u32(p: float) -> int:
    """Static uint32 threshold with P(draw < threshold) = p."""
    return max(0, min(0xFFFFFFFF, int(round(float(p) * 4294967296.0))))


def flips_at(s0, s1, site, nbits: int, p_u32: int) -> torch.Tensor:
    """Flip word at each ``site``: low ``nbits`` bit-planes i.i.d.
    Bernoulli(p), plane i from stream ``FLIP_SALT + i``."""
    word = 0
    for i in range(nbits):
        plane = (raw_draw(s0, s1, site, FLIP_SALT + i) < p_u32).to(torch.int64)
        word = word | (plane << i)
    return word


def site_index(shape: tuple, device=None) -> torch.Tensor:
    """Row-major linear site index over a per-chain state block."""
    n = 1
    for d in shape:
        n *= int(d)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def threefry2x32_device(k0, k1, x0, x1):
    """The ``csrc/rng.cuh`` cipher on the card, for its known-answer and
    parity checks: four equal-shape int64 CUDA tensors of uint32 words in,
    two out.  Launches a one-block-per-256-counters test kernel."""
    from repro_torch.kernels import _build

    args = [u32(a).contiguous() for a in (k0, k1, x0, x1)]
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"threefry2x32_device needs CUDA tensors, got {dev}")
    if any(a.shape != args[0].shape or a.device != dev for a in args):
        raise ValueError("threefry2x32_device inputs must share shape and device")
    lib = _build.library()
    a32 = [_build.to_u32_bits(a) for a in args]
    y0 = torch.empty_like(a32[0])
    y1 = torch.empty_like(a32[0])
    with torch.cuda.device(dev):
        err = lib.repro_threefry2x32(
            *(a.data_ptr() for a in a32), y0.data_ptr(), y1.data_ptr(),
            a32[0].numel(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "threefry2x32_kernel")
    return _build.from_u32_bits(y0), _build.from_u32_bits(y1)
