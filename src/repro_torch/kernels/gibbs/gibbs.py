"""Wrappers of the checkerboard Gibbs kernels (``csrc/gibbs.cu``).

``gibbs_chain`` replaces ``repro.kernels.gibbs.gibbs.gibbs_chain_pallas``
(the Pallas ``_gibbs_kernel``: uniforms as operands) and
``gibbs_chain_fused`` replaces ``gibbs_chain_pallas_fused``
(``_gibbs_fused_kernel``: uniforms drawn in-kernel from the counter
cipher).  For CUDA tensors each wrapper checks its inputs, launches its
kernel on the current stream and raises if a launch fails; for CPU
tensors it runs the plain version in ``ref.py``.  There is no other
fallback.

The conditional arrives as a logit spec, ``ref.IsingLogit`` or
``ref.SpinGlassLogit``; the kernel has one specialisation for each, and
any other spec raises ``ValueError``.  Spin words are {0, 1} values held
in int64 tensors on both sides of the wrapper; they cross into the kernel
as int32.  ``LAUNCHES`` counts the kernel calls of each wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gibbs.ref import (
    IsingLogit,
    SpinGlassLogit,
    gibbs_chain_fused_ref,
    gibbs_chain_ref,
)

LAUNCHES = {"gibbs_chain": 0, "gibbs_chain_fused": 0}

_INT = (torch.int32, torch.int64)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, x: torch.Tensor, shape: tuple, dtypes, device) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the lattice on {device}")


def _check_lattice(init: torch.Tensor, logit, k: int) -> torch.device:
    if init.ndim != 3 or init.dtype not in _INT:
        raise ValueError(
            f"init must be a (B, H, W) integer lattice, got {tuple(init.shape)} {init.dtype}"
        )
    b, h, w = init.shape
    if not (0 < b and h >= 2 and w >= 2 and k >= 1):
        raise ValueError(f"Gibbs kernel needs B >= 1, H, W >= 2, K >= 1; got {b, h, w, k}")
    if init.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Gibbs kernel for device {init.device}")
    if isinstance(logit, SpinGlassLogit):
        for name in ("j_right", "j_down"):
            j = getattr(logit, name)
            _check(name, j, (h, w), (torch.float32,), init.device)
            if not j.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif not isinstance(logit, IsingLogit):
        raise ValueError(
            f"the Gibbs kernels know IsingLogit and SpinGlassLogit, got "
            f"{type(logit).__name__}"
        )
    return init.device


def _check_grid(b: int, h: int, w: int, k: int) -> None:
    """Sizes the kernel's grid and 32-bit site indices can take."""
    if not (b <= 65535 and h * w < 2**31 and k < 2**31):
        raise ValueError(f"Gibbs kernel cannot take B={b}, H={h}, W={w}, K={k}")


def gibbs_chain(
    init: torch.Tensor,     # (B, H, W) {0, 1} spin words (int64)
    u: torch.Tensor,        # (K, B, H, W) float32
    logit,                  # IsingLogit | SpinGlassLogit
    parity0: torch.Tensor,  # (B,) per-lattice starting parity
):
    """K checkerboard half-sweeps over B lattices, uniforms as operands.

    Returns (samples (K, B, H, W) words as int64, flips (B, H, W) int32).
    """
    k = u.shape[0] if u.ndim == 4 else 0
    dev = _check_lattice(init, logit, k)
    b, h, w = init.shape
    _check("u", u, (k, b, h, w), (torch.float32,), dev)
    _check("parity0", parity0, (b,), _INT, dev)
    if dev.type == "cpu":
        return gibbs_chain_ref(init, u, logit, parity0)
    _check_grid(b, h, w, k)
    samples, flips = _launch_gibbs_chain(
        _build.to_u32_bits(init), u.contiguous(), logit, _build.to_u32_bits(parity0)
    )
    return _build.from_u32_bits(samples), flips


def _logit_args(logit) -> tuple[str, tuple]:
    """The entry-point suffix and the leading logit arguments of a spec."""
    if isinstance(logit, SpinGlassLogit):
        return "_spin_glass", (
            logit.j_right.data_ptr(), logit.j_down.data_ptr(),
            ctypes.c_float(logit.field),
        )
    return "", (ctypes.c_float(logit.beta), ctypes.c_float(logit.field))


def _launch_gibbs_chain(init32, u, logit, parity32):
    """K launches of ``gibbs_chain_kernel`` with ``OperandDraw`` (one call)."""
    lib = _build.library()
    k, b, h, w = u.shape
    samples = torch.empty((k, b, h, w), dtype=torch.int32, device=u.device)
    flips = torch.empty((b, h, w), dtype=torch.int32, device=u.device)
    suffix, largs = _logit_args(logit)
    with torch.cuda.device(u.device):
        err = getattr(lib, "repro_gibbs_chain" + suffix)(
            init32.data_ptr(), u.data_ptr(), parity32.data_ptr(), *largs,
            samples.data_ptr(), flips.data_ptr(), b, h, w, k,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(lib, err, f"gibbs_chain_kernel<OperandDraw>{suffix}")
    LAUNCHES["gibbs_chain"] += 1
    return samples, flips


def gibbs_chain_fused(
    init: torch.Tensor,   # (B, H, W) {0, 1} spin words (int64)
    k0b: torch.Tensor,    # (B,) uint32 per-lattice chain-key word 0
    k1b: torch.Tensor,    # (B,) uint32 per-lattice chain-key word 1
    t0b: torch.Tensor,    # (B,) per-lattice absolute-step base
    logit,                # IsingLogit | SpinGlassLogit
    *,
    n_steps: int,
    lat_b: int,
):
    """K half-sweeps with the uniforms drawn in-kernel: half-sweep k of
    lattice i draws ``uniform_at(step_key(k0b[i], k1b[i], t0b[i] + k),
    (i % lat_b) * H * W + h * W + w)`` and updates the colour
    ``(t0b[i] + k) % 2``.  ``lat_b`` is the per-chain lattice count."""
    dev = _check_lattice(init, logit, n_steps)
    b, h, w = init.shape
    for name, x in (("k0b", k0b), ("k1b", k1b), ("t0b", t0b)):
        _check(name, x, (b,), _INT, dev)
    if not 0 < lat_b <= b:
        raise ValueError(f"need 0 < lat_b <= B={b}, got {lat_b}")
    if dev.type == "cpu":
        return gibbs_chain_fused_ref(init, k0b, k1b, t0b, logit, n_steps, lat_b)
    _check_grid(b, h, w, n_steps)
    samples, flips = _launch_gibbs_chain_fused(
        _build.to_u32_bits(init), _build.to_u32_bits(k0b), _build.to_u32_bits(k1b),
        _build.to_u32_bits(t0b), logit, n_steps=n_steps, lat_b=lat_b,
    )
    return _build.from_u32_bits(samples), flips


def _launch_gibbs_chain_fused(init32, k0b32, k1b32, t0b32, logit, *, n_steps, lat_b):
    """K launches of ``gibbs_chain_kernel`` with ``FusedDraw`` (one call)."""
    lib = _build.library()
    b, h, w = init32.shape
    samples = torch.empty((n_steps, b, h, w), dtype=torch.int32, device=init32.device)
    flips = torch.empty((b, h, w), dtype=torch.int32, device=init32.device)
    suffix, largs = _logit_args(logit)
    with torch.cuda.device(init32.device):
        err = getattr(lib, "repro_gibbs_chain_fused" + suffix)(
            init32.data_ptr(), k0b32.data_ptr(), k1b32.data_ptr(), t0b32.data_ptr(),
            *largs, samples.data_ptr(), flips.data_ptr(), b, h, w, n_steps, lat_b,
            torch.cuda.current_stream(init32.device).cuda_stream,
        )
    _build.check(lib, err, f"gibbs_chain_kernel<FusedDraw>{suffix}")
    LAUNCHES["gibbs_chain_fused"] += 1
    return samples, flips
