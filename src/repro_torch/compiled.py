"""Compiled programs: the port's counterpart of one ``jax.jit`` cache entry.

The JAX package runs its hot paths as jitted programs, one for each
signature (its static arguments and its inputs' layouts).  On the card the
counterpart of one such program is a CUDA graph: the function captured
once over static input buffers, then replayed by one graph launch.  Its
callers keep such programs, each in a dict keyed by its own signature and
on the object whose tensors the graphs bake in, so that they die with it:
``MHEngine.submit(compiled=True)`` (``samplers/plan.py``, on its engine);
tempering's scan segments (``tempering/exchange.py``, on the
``ReplicaExchange`` for its last run's targets, in one memory pool); the
token sampler (``core/token_sampler.py``, a module-level cache as JAX's
is); ``BatchedServer``'s decode step (``launch/serve.py``); the training
launcher's step (``launch/train.py``, one cache a run); and the serving
tier's advances, a scan class's and a kernel class's
(``serving/dispatch.py``, on their advance function, rebuilt when a class
gains a member).

On the CPU there is no graph: the cache keeps the signature and the
function runs directly, so the cache's size is the card's.  On the card a
failed capture or replay raises ``RuntimeError`` naming the signature; the
function never runs eagerly in its place.  A captured function must not
copy from the host or read the card from the host: fill a scalar with
``torch.full((), x, device=...)``, never ``torch.tensor(x, device=cuda)``.

A caller may mark parts of its function as sections (``section``): a
gated capture cuts the capture at the edges of every section, so the
program is a sequence of graphs sharing one memory pool, and every call
names the sections its replay runs (``call``'s ``enable``): the graphs
between sections always replay, a section's only when named.  One
program then serves every choice of sections at the cost of the ones
chosen.  The scan class advance runs each slot's own member this way.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import warnings
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
# one capture stream a device for the gated captures
_CAPTURE_STREAMS: dict = {}
# a measurement switch: keep every program's graph template to count its
# nodes (``Program.nodes``, ``cuGraphGetNodes``)
KEEP_GRAPHS = False
# the gated capture in progress (``section``)
_RECORDING: "_Pieces | None" = None


@dataclasses.dataclass
class Program:
    """One signature's program.  ``holds`` keeps alive what the graph's
    addresses point into (an engine, a target, a model and its cache), so
    that no later tensor, and no ``id`` Python reuses, can take their
    place; on the card also the graph, its static inputs and result, the
    kernel launches one run makes (``_COUNTERS``' order), the device
    bytes it holds, the graph's node count (kept graphs only) and, on a
    gated program (whose ``graph`` is a ``_Pieces``), its sections'
    keys, each with its node count (kept graphs only)."""

    holds: Any = None
    graph: Any = None
    inputs: tuple = ()
    result: Any = None
    launches: tuple = ()
    nbytes: int = 0
    nodes: int = 0
    sections: dict = dataclasses.field(default_factory=dict)


def layout(x) -> tuple | None:
    """(shape, dtype name) of a tensor, None for an absent input."""
    return None if x is None else (tuple(x.shape), str(x.dtype).removeprefix("torch."))


def _launch_counts() -> tuple:
    return tuple(dict(c) for c in _COUNTERS)


def _counted_since(counts: tuple) -> tuple:
    return tuple({k: now[k] - before[k] for k in now}
                 for now, before in zip(_launch_counts(), counts))


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


def _graph_nodes(graph: int) -> int:
    """The node count of a kept graph (``cuGraphGetNodes`` of ``libcuda``)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t))
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get_nodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(n.value)


class _Pieces:
    """A gated program's graphs: its capture cut at the edges of every
    section, in capture order, each with the key of its section (None
    between sections) and the kernel launches it makes.  All share one
    memory pool; they replay in order on one stream, so a piece's
    temporaries may reuse another's memory."""

    def __init__(self, pool):
        self.pieces: list = []
        self._pool = pool
        self._open = None

    def pool(self):
        return self._pool

    def cut(self, key=None, last: bool = False) -> None:
        """End the piece being captured; unless ``last``, begin the next,
        of section ``key``."""
        if self._open is not None:
            open_key, graph, counts = self._open
            self._open = None
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                graph.capture_end()
            # the piece between two sections captures nothing: drop it
            empty = False
            for w in caught:
                if str(w.message).startswith("The CUDA Graph is empty"):
                    empty = True
                else:
                    warnings.warn(w.message, w.category)
            self._pool = graph.pool()
            if not empty or open_key is not None:
                self.pieces.append((open_key, graph, _counted_since(counts)))
        if not last:
            graph = torch.cuda.CUDAGraph(keep_graph=KEEP_GRAPHS)
            self._open = (key, graph, _launch_counts())
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")

    def abort(self) -> None:
        """End a capture that failed, keeping nothing."""
        if self._open is not None:
            with contextlib.suppress(Exception):
                self._open[1].capture_end()
            self._open = None

    def replay(self, enable) -> list:
        """Launch the pieces between sections and the sections in
        ``enable``; the launch counts of those replayed."""
        launched = []
        for key, graph, launches in self.pieces:
            if key is None or key in enable:
                graph.replay()
                launched.append(launches)
        return launched


@contextlib.contextmanager
def section(key):
    """Mark the work issued inside the block as section ``key`` of the
    program a gated capture is recording: the capture is cut before and
    after it, and a replay runs it only when its call names ``key``.
    Yields True there, and False (cutting nothing) anywhere else:
    eagerly, in a capture's warm-up and in an ungated capture."""
    pieces = _RECORDING
    if pieces is None or not torch.cuda.is_current_stream_capturing():
        yield False
        return
    pieces.cut(key)
    yield True
    pieces.cut(None)


def _cloned(result):
    items = [x.clone() if isinstance(x, torch.Tensor) else x for x in result]
    return type(result)(*items) if hasattr(result, "_fields") else tuple(items)


def capture(fn: Callable, inputs: tuple, device, what: str, holds=None, name=None,
            gated: bool = False, pool=None):
    """A new signature's program and this call's result ``fn(*inputs)``.

    ``fn`` returns a tuple (or named tuple) of tensors and plain values;
    ``inputs`` are tensors or None.  On the card: one warm-up run on a
    side stream over static copies of the inputs (it builds the kernels
    and makes every cached table outside the capture, and its result is
    this call's), then one run captured into a CUDA graph over the same
    buffers.  The capture launches nothing, so the launch counters are put
    back after it and the program keeps what it counted, to add on every
    replay.  ``gated`` cuts the capture at ``fn``'s sections
    (``section``) into a ``_Pieces``; ``pool`` is a memory pool
    (``CUDAGraph.pool()``) the capture shares with programs that never
    run at the same time as this one."""
    global _RECORDING
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
        graph = _Pieces(pool) if gated else torch.cuda.CUDAGraph(keep_graph=KEEP_GRAPHS)
        # no cyclic collection during the capture: a dead cycle holding
        # another program (a dropped scheduler is one) would destroy its
        # graph mid-capture, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            if gated:
                stream = _CAPTURE_STREAMS.get(device)
                if stream is None:
                    stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
                torch.cuda.synchronize(device)
                _RECORDING = graph
                with torch.cuda.stream(stream):
                    graph.cut()
                    out = fn(*buffers)
                    graph.cut(last=True)
            else:
                # thread_local: NCCL's watchdog thread may query the card meanwhile
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    out = fn(*buffers)
        except Exception as exc:
            if gated:
                graph.abort()
            raise RuntimeError(
                f"{what}: capturing {name} as a CUDA graph (torch.cuda.graph) "
                f"failed: {exc}"
            ) from exc
        finally:
            _RECORDING = None
            if collecting:
                gc.enable()
            captured = _counted_since(counts)
            _add_launches(captured, -1)
        if KEEP_GRAPHS:
            try:
                for key, piece in (((None, graph),) if not gated else
                                   ((k, g) for k, g, _ in graph.pieces)):
                    n = _graph_nodes(piece.raw_cuda_graph())
                    piece.instantiate()
                    program.nodes += n
                    if key is not None:
                        program.sections[key] = n
            except Exception as exc:
                raise RuntimeError(
                    f"{what}: instantiating the captured {name} failed: {exc}") from exc
        if gated:
            program.sections = {k: program.sections.get(k, 0)
                                for k, _, _ in graph.pieces if k is not None}
        program.graph, program.inputs, program.result = graph, buffers, out
        program.launches = captured
        program.nbytes = torch.cuda.memory_reserved(device) - reserved + sum(
            x.numel() * x.element_size() for x in buffers if x is not None
        )
    return program, result


def replay(program: Program, inputs: tuple, what: str, enable=None):
    """Copy the inputs in, launch the graph on the current stream (a gated
    program's pieces between sections and the sections in ``enable``),
    and return clones of its outputs: a later replay never changes a
    result already handed out."""
    device = next(x for x in program.inputs if x is not None).device
    with torch.cuda.device(device):
        _stage(program.inputs, inputs)
        try:
            if enable is None:
                program.graph.replay()
                launched = [program.launches]
            else:
                launched = program.graph.replay(enable)
        except Exception as exc:
            raise RuntimeError(f"{what}: CUDAGraph.replay failed: {exc}") from exc
        for launches in launched:
            _add_launches(launches)
        return _cloned(program.result)


def call(programs: dict, sig, fn: Callable, inputs: tuple, device, what: str, holds=None,
         name=None, enable=None, share_pool: bool = False):
    """``fn(*inputs)`` through the program of ``sig`` in ``programs``:
    (result, ``"miss"`` when this call captured it, ``"hit"`` when it
    reused it).  A program without a graph (the CPU's) runs ``fn``
    directly.  ``enable`` (a set of section keys) makes the program gated:
    a replay runs those sections and no other, and ``fn`` run directly
    must compute that result.  ``share_pool`` captures into the
    memory pool of the programs already in ``programs``, which the caller
    replays one at a time on one stream."""
    program = programs.get(sig)
    if program is None:
        pool = next((p.graph.pool() for p in programs.values() if p.graph is not None),
                    None) if share_pool else None
        program, result = capture(fn, inputs, device, what, holds, name,
                                  gated=enable is not None, pool=pool)
        programs[sig] = program
        return result, "miss"
    if program.graph is None:
        return fn(*inputs), "hit"
    return replay(program, inputs, what, enable), "hit"
