"""Wrapper of the MSXOR debias kernel (``csrc/msxor.cu``).

``msxor`` replaces ``repro.kernels.msxor.msxor.msxor_pallas`` (the Pallas
``_msxor_kernel``): (G = 2**n_stages, M) raw words folded into (M,)
debiased words, or into uniforms ``(w >> 8) * 2^-24``.  For a CUDA tensor
it checks its input, launches the kernel on the current stream and raises
if the launch fails; for a CPU tensor it runs the plain version in
``ref.py``.  There is no other fallback.

Words are uint32 values held in int64 tensors, and the kernel reads them
as they are (the low 32 bits of each); int32 bit patterns are accepted too
and widened to int64 first.  ``LAUNCHES`` counts the kernel's launches,
and a compiled submit's replay adds what its captured run launched
(``samplers/plan.py``), as for the MH and Gibbs kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.msxor.ref import msxor_fold_ref, msxor_uniform_ref

LAUNCHES = {"msxor": 0}

MAX_STAGES = 5  # G = 32 raw words per column at most, as the TPU kernel unrolls


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def msxor(raw: torch.Tensor, n_stages: int = 3, to_uniform: bool = False) -> torch.Tensor:
    """raw: (G, M) uint32 words, G == 2**n_stages, any M >= 1.

    Returns (M,) debiased words (int64), or (M,) float32 uniforms if
    ``to_uniform``.
    """
    if not 1 <= n_stages <= MAX_STAGES:
        raise ValueError(f"n_stages must be in [1, {MAX_STAGES}], got {n_stages}")
    if raw.ndim != 2 or raw.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"raw must be (G, M) integer words, got {tuple(raw.shape)} {raw.dtype}"
        )
    g, m = raw.shape
    if g != (1 << n_stages):
        raise ValueError(f"G must be 2**{n_stages}, got {g}")
    if m < 1:
        raise ValueError("M must be >= 1")
    if raw.device.type == "cpu":
        ref = msxor_uniform_ref if to_uniform else msxor_fold_ref
        return ref(raw, n_stages)
    if raw.device.type != "cuda":
        raise ValueError(f"no MSXOR kernel for device {raw.device}")
    return _launch_msxor(
        raw.to(torch.int64).contiguous(), n_stages=n_stages, to_uniform=to_uniform
    )


def _launch_msxor(raw: torch.Tensor, *, n_stages: int, to_uniform: bool):
    """One launch of ``msxor_kernel`` on contiguous int64 words; returns
    int64 words, or float32 uniforms."""
    lib = _build.library()
    m = raw.shape[1]
    dtype = torch.float32 if to_uniform else torch.int64
    out = torch.empty((m,), dtype=dtype, device=raw.device)
    with torch.cuda.device(raw.device):
        err = lib.repro_msxor(
            raw.data_ptr(), out.data_ptr(), n_stages, m, int(to_uniform),
            torch.cuda.current_stream(raw.device).cuda_stream,
        )
    _build.check(lib, err, "msxor_kernel")
    LAUNCHES["msxor"] += 1
    return out
