"""Wrappers of the checkerboard Gibbs kernel (``csrc/gibbs.cu``).

``gibbs_chain`` replaces ``repro.kernels.gibbs.gibbs.gibbs_chain_pallas``
(the Pallas ``_gibbs_kernel``: uniforms as operands) and
``gibbs_chain_fused`` replaces ``gibbs_chain_pallas_fused``
(``_gibbs_fused_kernel``: uniforms drawn in-kernel from the counter
cipher).  Both launch ``gibbs_band_kernel`` (``OperandDraw`` and
``FusedDraw``): one cooperative launch per group of lattices, each block
keeping a band of rows in shared memory for all K half-sweeps.  For CUDA
tensors each wrapper checks its inputs, launches the kernel on the
current stream and raises if a launch fails or is refused; for CPU
tensors it runs the plain version in ``ref.py``.  There is no other
fallback.

The conditional arrives as a logit spec, ``ref.IsingLogit`` or
``ref.SpinGlassLogit``, its ``scale`` included (a tempered replica's
beta); the kernel has one specialisation for each, and any other spec
raises ``ValueError``.  Spins are {0, 1} values; they go in
as any integer tensor and come out as int32, never widened here (the
engine widens the rows it keeps).  ``plan_groups`` splits a batch into
the groups one cooperative launch can hold and raises for a lattice too
large for the card's shared memory (the per-lattice limit, the same for
both entry points).  ``LAUNCHES`` counts kernel launches, one per lattice
group of a call: the kernel's runs on the card, on either path.  A direct
run counts each launch from the host; a compiled submit's capture
(``samplers/plan.py``) counts nothing, and each replay of its CUDA graph
adds what the captured run launched.  The ready flags are zeroed by a
``torch.zeros`` on every call, which a capture records as a device fill, so
every replay starts from zeroed flags.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


def _check_grid(h: int, w: int, k: int) -> None:
    """Sizes the kernel's 32-bit site indices and step counts can take."""
    if not (h * w < 2**31 and k < 2**31):
        raise ValueError(f"Gibbs kernel cannot take H={h}, W={w}, K={k}")


def _spins32(init: torch.Tensor) -> torch.Tensor:
    """{0, 1} spins as a contiguous int32 tensor (no copy if they are one)."""
    return init.to(torch.int32).contiguous()


def gibbs_chain(
    init: torch.Tensor,     # (B, H, W) {0, 1} spins (int32 or int64)
    u: torch.Tensor,        # (K, B, H, W) float32
    logit,                  # IsingLogit | SpinGlassLogit
    parity0: torch.Tensor,  # (B,) per-lattice starting parity
):
    """K checkerboard half-sweeps over B lattices, uniforms as operands.

    Returns (samples (K, B, H, W) int32 spins, flips (B, H, W) int32).
    """
    k = u.shape[0] if u.ndim == 4 else 0
    dev = _check_lattice(init, logit, k)
    b, h, w = init.shape
    _check("u", u, (k, b, h, w), (torch.float32,), dev)
    _check("parity0", parity0, (b,), _INT, dev)
    if dev.type == "cpu":
        return gibbs_chain_ref(init, u, logit, parity0)
    _check_grid(h, w, k)
    return _launch_gibbs_chain(
        _spins32(init), u.contiguous(), logit, _build.to_u32_bits(parity0)
    )


def _logit_args(logit) -> tuple[str, tuple]:
    """The entry-point suffix and the leading logit arguments of a spec."""
    if isinstance(logit, SpinGlassLogit):
        return "_spin_glass", (
            logit.j_right.data_ptr(), logit.j_down.data_ptr(),
            ctypes.c_float(logit.field), ctypes.c_float(logit.scale),
        )
    return "", (
        ctypes.c_float(logit.beta), ctypes.c_float(logit.field), ctypes.c_float(logit.scale),
    )


def _launch_gibbs_chain(init32, u, logit, parity32, groups=None):
    """One cooperative launch of ``gibbs_band_kernel<OperandDraw>`` per
    lattice group (``plan_groups`` on this card unless ``groups`` is
    given)."""
    suffix, largs = _logit_args(logit)
    return _launch_bands(
        "repro_gibbs_chain" + suffix, f"gibbs_band_kernel<OperandDraw>{suffix}", "gibbs_chain",
        init32, (u.data_ptr(), parity32.data_ptr(), *largs), (), u.shape[0], groups,
    )


def _launch_bands(entry, kernel, counter, init32, lead, tail, n_steps, groups):
    """The launches of one call: ``entry(init, *lead, samples, flips,
    ready, B, H, W, K, *tail, b0, lattices, bands, rows, stream)`` once per
    lattice group, each group with its own zeroed ready flags; counts each
    launch in ``LAUNCHES[counter]``."""
    lib = _build.library()
    b, h, w = init32.shape
    dev = init32.device
    if groups is None:
        groups = plan_groups(b, h, w, **band_limits(dev.index, w))
    samples = torch.empty((n_steps, b, h, w), dtype=torch.int32, device=dev)
    flips = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    ready = torch.zeros(
        (len(groups), max(g.lattices * g.bands for g in groups)), dtype=torch.int32, device=dev
    )
    launch = getattr(lib, entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g, flags in zip(groups, ready):
            err = launch(
                init32.data_ptr(), *lead, samples.data_ptr(), flips.data_ptr(),
                flags.data_ptr(), b, h, w, n_steps, *tail, g.b0, g.lattices, g.bands, g.rows,
                stream,
            )
            _build.check(lib, err, kernel)
            LAUNCHES[counter] += 1
    return samples, flips


# --- the band kernel's launch plan ------------------------------------------


class Group(NamedTuple):
    """One cooperative launch: ``lattices`` lattices from ``b0``, each cut
    into ``bands`` bands of ``rows`` rows (the last band may be shorter)."""

    b0: int
    lattices: int
    bands: int
    rows: int


def plan_groups(b: int, h: int, w: int, *, max_blocks: int, max_rows: int) -> list[Group]:
    """Split B lattices of H x W into consecutive groups, each one
    cooperative launch of at most ``max_blocks`` blocks (one per SM), as
    few groups as can be and of sizes within one of each other; each
    lattice gets as many bands as its group's share of the blocks allows.
    Lattice i keeps its index, so its site base ``(i % lat_b) * H * W``.
    ``max_rows`` is the most rows a band of width ``w`` may have
    (``band_limits``).

    Raises ``ValueError`` for a lattice that needs more bands than the
    card holds blocks (the per-lattice limit)."""
    need = -(-h // max_rows) if max_rows > 0 else None
    if need is None or need > max_blocks:
        raise ValueError(
            f"a {h} x {w} lattice is too large for one cooperative launch of the "
            f"band kernel: a band holds at most {max_rows} rows of {w} sites "
            f"(what one block holds), and a lattice at most "
            f"{max_blocks} bands (one block per SM)"
        )
    n_groups = -(-b // min(b, max_blocks // need))
    groups, b0 = [], 0
    for g in range(n_groups):
        size = b // n_groups + (g < b % n_groups)
        rows = -(-h // min(h, max_blocks // size))
        groups.append(Group(b0, size, -(-h // rows), rows))
        b0 += size
    return groups


@functools.lru_cache(maxsize=None)
def band_limits(device_index: int, w: int) -> dict:
    """What the band kernel can take on a card for lattices ``w`` sites
    wide, as ``csrc/gibbs.cu`` reckons it: blocks a launch (one per SM)
    and the most rows a band may have.  Raises if the card has no
    cooperative launch."""
    lib = _build.library()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = lib.repro_gibbs_band_limits(w, out)
    _build.check(lib, err, "repro_gibbs_band_limits")
    if not out[2]:
        raise RuntimeError(f"cuda:{device_index} cannot launch cooperative kernels")
    return {"max_blocks": out[0], "max_rows": out[1]}


def gibbs_chain_fused(
    init: torch.Tensor,   # (B, H, W) {0, 1} spins (int32 or int64)
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
    ``(t0b[i] + k) % 2``.  ``lat_b`` is the per-chain lattice count.

    Returns (samples (K, B, H, W) int32 spins, flips (B, H, W) int32)."""
    dev = _check_lattice(init, logit, n_steps)
    b, h, w = init.shape
    for name, x in (("k0b", k0b), ("k1b", k1b), ("t0b", t0b)):
        _check(name, x, (b,), _INT, dev)
    if not 0 < lat_b <= b:
        raise ValueError(f"need 0 < lat_b <= B={b}, got {lat_b}")
    if dev.type == "cpu":
        return gibbs_chain_fused_ref(init, k0b, k1b, t0b, logit, n_steps, lat_b)
    _check_grid(h, w, n_steps)
    return _launch_gibbs_chain_fused(
        _spins32(init), _build.to_u32_bits(k0b), _build.to_u32_bits(k1b),
        _build.to_u32_bits(t0b), logit, n_steps=n_steps, lat_b=lat_b,
    )


def _launch_gibbs_chain_fused(init32, k0b32, k1b32, t0b32, logit, *, n_steps, lat_b,
                              groups=None):
    """One cooperative launch of ``gibbs_band_kernel<FusedDraw>`` per
    lattice group (``plan_groups`` on this card unless ``groups`` is
    given)."""
    suffix, largs = _logit_args(logit)
    return _launch_bands(
        "repro_gibbs_chain_fused" + suffix, f"gibbs_band_kernel<FusedDraw>{suffix}",
        "gibbs_chain_fused", init32,
        (k0b32.data_ptr(), k1b32.data_ptr(), t0b32.data_ptr(), *largs), (lat_b,), n_steps,
        groups,
    )
