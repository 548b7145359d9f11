"""Compiled programs: the port's counterpart of one ``jax.jit`` cache entry.

The JAX package runs its hot paths as jitted programs, one for each
signature (its static arguments and its inputs' layouts).  On the card the
counterpart of one such program is a CUDA graph: the function captured
once over static input buffers, then replayed by one graph launch.  Three
callers keep such programs, each in a dict keyed by its own signature and
on the object whose tensors the graphs bake in, so that they die with it:
``MHEngine.submit(compiled=True)`` (``samplers/plan.py``), the token
sampler (``core/token_sampler.py``, a module-level cache as JAX's is) and
``BatchedServer``'s decode step (``launch/serve.py``).

On the CPU there is no graph: the cache keeps the signature and the
function runs directly, so the cache's size is the card's.  On the card a
failed capture or replay raises ``RuntimeError`` naming the signature; the
function never runs eagerly in its place.  A captured function must not
copy from the host or read the card from the host: fill a scalar with
``torch.full((), x, device=...)``, never ``torch.tensor(x, device=cuda)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.gibbs import gibbs as gibbs_kernel
from repro_torch.kernels.mh import mh as mh_kernel
from repro_torch.kernels.msxor import msxor as msxor_kernel

# the kernel launch counters a captured function moves
_COUNTERS = (mh_kernel.LAUNCHES, gibbs_kernel.LAUNCHES, msxor_kernel.LAUNCHES)
# one warm-up stream a device: PyTorch keeps a cuBLAS workspace (32 MiB on
# the H100) for every stream a product ran on, for the life of the process
_WARMUP_STREAMS: dict = {}


@dataclasses.dataclass
class Program:
    """One signature's program.  ``holds`` keeps alive what the graph's
    addresses point into (an engine, a target, a model and its cache), so
    that no later tensor, and no ``id`` Python reuses, can take their
    place; on the card also the graph, its static inputs and result, the
    kernel launches one run makes (``_COUNTERS``' order) and the device
    bytes it holds."""

    holds: Any = None
    graph: Any = None
    inputs: tuple = ()
    result: Any = None
    launches: tuple = ()
    nbytes: int = 0


def layout(x) -> tuple | None:
    """(shape, dtype name) of a tensor, None for an absent input."""
    return None if x is None else (tuple(x.shape), str(x.dtype).removeprefix("torch."))


def _launch_counts() -> tuple:
    return tuple(dict(c) for c in _COUNTERS)


def _add_launches(counts: tuple, sign: int = 1) -> None:
    for counter, n in zip(_COUNTERS, counts):
        for name, k in n.items():
            counter[name] += sign * k


def _stage(buffers: tuple, inputs: tuple) -> None:
    """Copy a call's inputs into a program's static buffers on the current
    stream: a card's tensor by a device copy, a host tensor through pinned
    memory, neither waiting for the card."""
    for buf, x in zip(buffers, inputs):
        if buf is not None:
            buf.copy_(x.pin_memory() if x.device.type == "cpu" else x, non_blocking=True)


def _cloned(result):
    items = [x.clone() if isinstance(x, torch.Tensor) else x for x in result]
    return type(result)(*items) if hasattr(result, "_fields") else tuple(items)


def capture(fn: Callable, inputs: tuple, device, what: str, holds=None, name=None):
    """A new signature's program and this call's result ``fn(*inputs)``.

    ``fn`` returns a tuple (or named tuple) of tensors and plain values;
    ``inputs`` are tensors or None.  On the card: one warm-up run on a
    side stream over static copies of the inputs (it builds the kernels
    and makes every cached table outside the capture, and its result is
    this call's), then one run captured into a CUDA graph over the same
    buffers.  The capture launches nothing, so the launch counters are put
    back after it and the program keeps what it counted, to add on every
    replay."""
    program = Program(holds=holds)
    device = torch.device(device)
    if device.type != "cuda":
        return program, fn(*inputs)
    name = name or getattr(fn, "__name__", "the function")
    with torch.cuda.device(device):
        buffers = tuple(
            None if x is None else torch.empty(x.shape, dtype=x.dtype, device=device)
            for x in inputs
        )
        _stage(buffers, inputs)
        current = torch.cuda.current_stream(device)
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = fn(*buffers)
        current.wait_stream(side)
        for x in result:
            if isinstance(x, torch.Tensor):
                x.record_stream(current)
        torch.cuda.empty_cache()  # as the capture does: its pool alone is counted
        reserved = torch.cuda.memory_reserved(device)
        counts = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: NCCL's watchdog thread may query the card meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*buffers)
        except Exception as exc:
            raise RuntimeError(
                f"{what}: capturing {name} as a CUDA graph (torch.cuda.graph) "
                f"failed: {exc}"
            ) from exc
        finally:
            captured = tuple(
                {k: now[k] - before[k] for k in now}
                for now, before in zip(_launch_counts(), counts)
            )
            _add_launches(captured, -1)
        program.graph, program.inputs, program.result = graph, buffers, out
        program.launches = captured
        program.nbytes = torch.cuda.memory_reserved(device) - reserved + sum(
            x.numel() * x.element_size() for x in buffers if x is not None
        )
    return program, result


def replay(program: Program, inputs: tuple, what: str):
    """Copy the inputs in, launch the graph on the current stream, and
    return clones of its outputs: a later replay never changes a result
    already handed out."""
    device = next(x for x in program.inputs if x is not None).device
    with torch.cuda.device(device):
        _stage(program.inputs, inputs)
        try:
            program.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"{what}: CUDAGraph.replay failed: {exc}") from exc
        _add_launches(program.launches)
        return _cloned(program.result)


def call(programs: dict, sig, fn: Callable, inputs: tuple, device, what: str, holds=None,
         name=None):
    """``fn(*inputs)`` through the program of ``sig`` in ``programs``:
    (result, ``"miss"`` when this call captured it, ``"hit"`` when it
    reused it).  A program without a graph (the CPU's) runs ``fn``
    directly."""
    program = programs.get(sig)
    if program is None:
        program, result = capture(fn, inputs, device, what, holds, name)
        programs[sig] = program
        return result, "miss"
    if program.graph is None:
        return fn(*inputs), "hit"
    return replay(program, inputs, what), "hit"
