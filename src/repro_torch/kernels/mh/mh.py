"""Wrappers of the fused MH chain kernels (``csrc/mh.cu``).

``mh_chain`` replaces ``repro.kernels.mh.mh.mh_chain_pallas`` (the Pallas
``_mh_kernel``: randomness as operands) and ``mh_chain_fused`` replaces
``mh_chain_pallas_fused`` (``_mh_fused_kernel``: randomness drawn
in-kernel from the counter cipher).  For CUDA tensors each wrapper checks
its inputs, launches its kernel on the current stream and raises if the
launch fails; for CPU tensors it runs the plain version in ``ref.py``,
which plays the role of the Pallas interpret mode.  There is no other
fallback.

Words are uint32 values held in int64 tensors, and the kernel reads and
writes them so (the low 32 bits), so a wrapper call on the card is one
kernel launch and nothing else.  ``LAUNCHES`` counts the kernel launches
of each wrapper: the kernel's runs on the card, on either path.  A direct
run counts each launch from the host; a compiled submit's capture
(``samplers/plan.py``) counts nothing, and each replay of its CUDA graph
adds what the captured run launched.  ``mh_chain``'s launch is the operator
``repro_torch::mh_chain`` (``torch.library``), so a dry run under fake
tensors on the card reaches it through its fake implementation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mh.ref import mh_chain_fused_ref, mh_chain_ref

LAUNCHES = {"mh_chain": 0, "mh_chain_fused": 0}

_WORDS = (torch.int64,)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, x: torch.Tensor, shape: tuple, dtypes, device) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the table on {device}")


def _check_table(table: torch.Tensor, nbits: int) -> torch.device:
    if table.ndim != 2 or table.dtype != torch.float32:
        raise ValueError(
            f"table must be (B, V) float32, got {tuple(table.shape)} {table.dtype}"
        )
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits must be in [1, 32], got {nbits}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no MH kernel for device {table.device}")
    return table.device


def _check_grid(b: int, c: int, v: int, k: int) -> None:
    """Sizes the kernel's grid and 32-bit arguments can take."""
    if not (0 < b <= 65535 and 0 < c < 2**31 and 0 < v < 2**31 and 0 <= k < 2**31):
        raise ValueError(f"MH kernel cannot take B={b}, C={c}, V={v}, K={k}")


def staged_vocab(device_index: int) -> int:
    """The longest table row (V) the kernel stages in shared memory on a
    card, as ``csrc/mh.cu`` reckons it; a longer row is gathered from
    global memory."""
    lib = _build.library()
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.repro_mh_staged_vocab(ctypes.byref(out))
    _build.check(lib, err, "repro_mh_staged_vocab")
    return out.value


def mh_chain(
    table: torch.Tensor,   # (B, V) float32
    init: torch.Tensor,    # (B, C) uint32 words (int64)
    flips: torch.Tensor,   # (K, B, C) uint32 flip words (int64)
    u: torch.Tensor,       # (K, B, C) float32
    nbits: int,
):
    """K MH steps over (B targets x C chains), randomness as operands.

    Returns (samples (K, B, C) uint32 words as int64, accept (B, C) int32).
    """
    dev = _check_table(table, nbits)
    b, v = table.shape
    k, c = flips.shape[0], init.shape[-1]
    _check("init", init, (b, c), _WORDS, dev)
    _check("flips", flips, (k, b, c), _WORDS, dev)
    _check("u", u, (k, b, c), (torch.float32,), dev)
    if dev.type == "cpu":
        return mh_chain_ref(table, init, flips, u, nbits)
    _check_grid(b, c, v, k)
    return _launch_mh_chain(
        table, init.contiguous(), flips.contiguous(), u.contiguous(), nbits
    )


@torch.library.custom_op("repro_torch::mh_chain", mutates_args=(), device_types="cuda")
def _launch_mh_chain(table: torch.Tensor, init: torch.Tensor, flips: torch.Tensor,
                     u: torch.Tensor, nbits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``mh_chain_kernel`` with ``OperandDraw``: the CUDA
    implementation of the operator ``repro_torch::mh_chain``, whose fake
    implementation gives a dry run (fake tensors, no storage) the
    outputs' shapes and dtypes."""
    lib = _build.library()
    k, b, c = flips.shape
    samples = torch.empty((k, b, c), dtype=torch.int64, device=table.device)
    accept = torch.empty((b, c), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        err = lib.repro_mh_chain(
            table.data_ptr(), init.data_ptr(), flips.data_ptr(), u.data_ptr(),
            samples.data_ptr(), accept.data_ptr(), b, table.shape[1], c, k,
            (1 << nbits) - 1, torch.cuda.current_stream(table.device).cuda_stream,
        )
    _build.check(lib, err, "mh_chain_kernel<OperandDraw>")
    LAUNCHES["mh_chain"] += 1
    return samples, accept


@_launch_mh_chain.register_fake
def _(table, init, flips, u, nbits):
    k, b, c = flips.shape
    return (table.new_empty((k, b, c), dtype=torch.int64),
            table.new_empty((b, c), dtype=torch.int32))


def mh_chain_fused(
    table: torch.Tensor,   # (B, V) float32
    init: torch.Tensor,    # (B, C) uint32 words (int64)
    k0c: torch.Tensor,     # (C,) uint32 per-column chain-key word 0
    k1c: torch.Tensor,     # (C,) uint32 per-column chain-key word 1
    t0c: torch.Tensor,     # (C,) per-column absolute-step base
    *,
    nbits: int,
    n_steps: int,
    cc: int,
    p_u32: int,
):
    """K MH steps with the flip words and uniforms drawn in-kernel: step
    ``t0c[c] + k`` at site ``b * cc + c % cc`` under key ``(k0c[c],
    k1c[c])``.  ``cc`` is the per-chain column count; ``p_u32`` the flip
    threshold (``rng.threshold_u32``)."""
    dev = _check_table(table, nbits)
    b, v = table.shape
    c = init.shape[-1]
    _check("init", init, (b, c), _WORDS, dev)
    for name, x in (("k0c", k0c), ("k1c", k1c), ("t0c", t0c)):
        _check(name, x, (c,), _WORDS, dev)
    if not 0 < cc <= c or not 0 <= p_u32 <= 0xFFFFFFFF:
        raise ValueError(f"need 0 < cc <= C={c} and p_u32 in uint32, got {cc}, {p_u32}")
    if dev.type == "cpu":
        return mh_chain_fused_ref(
            table, init, k0c, k1c, t0c, nbits=nbits, n_steps=n_steps, cc=cc,
            p_u32=p_u32,
        )
    _check_grid(b, c, v, n_steps)
    return _launch_mh_chain_fused(
        table, init.contiguous(), k0c.contiguous(), k1c.contiguous(),
        t0c.contiguous(), nbits=nbits, n_steps=n_steps, cc=cc, p_u32=p_u32,
    )


def _launch_mh_chain_fused(table, init, k0c, k1c, t0c, *, nbits, n_steps, cc, p_u32):
    """One launch of ``mh_chain_kernel`` with ``FusedDraw``."""
    lib = _build.library()
    b, c = init.shape
    samples = torch.empty((n_steps, b, c), dtype=torch.int64, device=table.device)
    accept = torch.empty((b, c), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        err = lib.repro_mh_chain_fused(
            table.data_ptr(), init.data_ptr(), k0c.data_ptr(),
            k1c.data_ptr(), t0c.data_ptr(), samples.data_ptr(),
            accept.data_ptr(), b, table.shape[1], c, n_steps, nbits, cc, p_u32,
            (1 << nbits) - 1, torch.cuda.current_stream(table.device).cuda_stream,
        )
    _build.check(lib, err, "mh_chain_kernel<FusedDraw>")
    LAUNCHES["mh_chain_fused"] += 1
    return samples, accept


def mh_chain_pallas_hwprng(*args, **kwargs):
    """Guard for the JAX package's TPU hardware-PRNG stub: a hardware
    stream (cuRAND, Philox) would break parity with the counter cipher
    the scan executor reproduces, so no device has this variant."""
    raise NotImplementedError(
        "the hardware-PRNG MH kernel has no port: use mh_chain_fused (the "
        "portable in-kernel counter RNG) or mh_chain with explicit "
        "randomness operands."
    )
