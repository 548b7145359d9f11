"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface.  At
first use each is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library under
``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, and loaded with ``ctypes``.  Nothing is
built when a module is imported, so the CPU tests never need ``nvcc``.

On the Python side the port carries uint32 words as int64.  The MH and
MSXOR kernels read and write those int64 tensors as they are (the low 32
bits); the Gibbs kernels and the cipher take their words as int32 tensors
holding the same 32 bits (``to_u32_bits`` / ``from_u32_bits``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("mh.cu", "gibbs.cu", "msxor.cu")
HEADERS = ("rng.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # table (f32), init (i64), flips (i64), u (f32), samples (i64),
    # accept (i32), B, V, C, K, mask, stream
    "repro_mh_chain": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _P),
    # table (f32), init, k0c, k1c, t0c (i64), samples (i64), accept (i32),
    # B, V, C, K, nbits, cc, p_u32, mask, stream
    "repro_mh_chain_fused": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _P
    ),
    # out: the longest row the MH kernel stages in shared memory
    "repro_mh_staged_vocab": (_P,),
    # k0, k1, x0, x1, y0, y1, n, stream
    "repro_threefry2x32": (_P, _P, _P, _P, _P, _P, _I, _P),
    # init, u, parity0, beta, field, scale, samples, flips, ready,
    # B, H, W, K, b0, lattices, bands, rows, stream
    "repro_gibbs_chain": (
        _P, _P, _P, _F, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P
    ),
    # init, u, parity0, j_right, j_down, field, scale, samples, flips, ready,
    # B, H, W, K, b0, lattices, bands, rows, stream
    "repro_gibbs_chain_spin_glass": (
        _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P
    ),
    # W, out[3]: SMs, most rows a band, cooperative launch
    "repro_gibbs_band_limits": (_I, _P),
    # init, k0b, k1b, t0b, beta, field, scale, samples, flips, ready,
    # B, H, W, K, lat_b, b0, lattices, bands, rows, stream
    "repro_gibbs_chain_fused": (
        _P, _P, _P, _P, _F, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P
    ),
    # init, k0b, k1b, t0b, j_right, j_down, field, scale, samples, flips,
    # ready, B, H, W, K, lat_b, b0, lattices, bands, rows, stream
    "repro_gibbs_chain_fused_spin_glass": (
        _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P
    ),
    # raw, out, n_stages, M, to_uniform, stream
    "repro_msxor": (_P, _P, _I, _L, _I, _P),
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of repro_torch are built at first use on a machine with "
            "the CUDA toolkit"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> str:
    """Run the commands side by side, wait for every one, and raise for
    the first that failed; returns their joined output."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    text, failed = "", None
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        text += stdout + stderr
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, stdout + stderr)
    if failed is not None:
        cmd, rc, output = failed
        raise RuntimeError(f"nvcc failed with exit code {rc}:\n{' '.join(cmd)}\n{output}")
    return text


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the kernels once per source hash; returns the library path,
    the build seconds (0 when an earlier process built it), the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) and whether
    it was cached."""
    out = BUILD_DIR / _digest() / "librepro_torch.so"
    log = out.with_name("build.log")
    if out.exists():
        text = log.read_text() if log.exists() else ""
        return {"path": str(out), "seconds": 0.0, "log": text, "cached": True}
    out.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    nvcc = _nvcc()
    objs = [str(out.with_name(f"{Path(src).stem}.{pid}.o")) for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{pid}.tmp")
    t0 = time.perf_counter()
    text = _run_all([  # one nvcc per source, all started together
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
        for src, obj in zip(SOURCES, objs)
    ])
    text += _run_all([[nvcc, "-shared", "-o", str(tmp), *objs]])
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    for obj in objs:
        os.remove(obj)
    log.write_text(text)
    return {"path": str(out), "seconds": seconds, "log": text, "cached": False}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every function's C signature set."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel} failed to launch: CUDA error {err} ({msg})")


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same 32 bits."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32).contiguous()


def from_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF
