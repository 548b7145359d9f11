"""Per-device cost of a step (FLOPs / HBM bytes / collective bytes) from
the op stream it issues — the port of ``repro.distributed.hlo_cost``.

The JAX package re-derives the three roofline inputs from the compiled
HLO text, multiplying while-loop bodies by their trip counts.  Eager
PyTorch has no HLO and no loops to unroll: the layers, microbatches and
logits chunks run one after another, and every op they issue passes the
dispatcher.  ``CostCounter`` is a dispatch mode that counts, on the
*local* tensors of this rank (DTensor desugars its ops first, see
``hlo_analysis.LocalOpMode``), so every number is per device:

  * **FLOPs** — matrix products only, as ``hlo_cost`` counts ``dot``
    only: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``,
    ``addmv`` and ``dot`` (``matmul``, ``einsum`` and ``linear``
    decompose into these before a dispatch mode sees them): 2 x |result|
    x contracted extent.  Convolutions and elementwise ops are left out.
  * **bytes** — operand plus result bytes of the "mandatory" op class,
    JAX's ``_MEMORY_OPS`` in torch terms: the products, copies, gathers
    and index writes, scatters, reductions, sorts, concatenations, pads
    and custom operators (the MH kernel).  An in-place index write or a
    copy into a view moves what it writes, read and written (JAX's
    ``dynamic-update-slice`` rule), not the whole buffer it lands in.
  * **bytes_upper** — the same rule over every op that moves data
    (elementwise ops too); views, metadata and ``empty`` allocations are
    free.
  * **collectives** — ``hlo_analysis``'s records, by kind, with
    ``"total"``.

``unknown_trip_loops`` is always 0 (nothing is rolled) and keeps its key.
A backward pass and a non-reentrant checkpoint's recompute are counted
as they run, so a step of ``remat_policy="nothing"`` counts its blocks'
forward products twice, as XLA's remat does.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.hlo_analysis import (
    LocalOpMode,
    WeightOrigin,
    classify,
    collective_bytes,
    tensor_bytes,
)

aten = torch.ops.aten

# product op -> index of its left matrix operand
_DOT_OPS = {
    aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
    aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1, aten.addbmm: 1,
}

# ops that write part of their first argument in place: they move what
# they write (read and written), never the whole target
_REGION_WRITES = {
    aten.copy_: 1, aten.index_put_: 2, aten._index_put_impl_: 2, aten.scatter_: 3,
    aten.scatter_add_: 3,
}

_MEMORY_OPS = {
    *_DOT_OPS,
    # copies
    aten._to_copy, aten.clone, aten.copy, aten.copy_, aten.contiguous,
    # gathers and index writes (dynamic-slice / dynamic-update-slice / gather / scatter)
    aten.index, aten.index_select, aten.gather, aten.take_along_dim, aten.embedding,
    aten.index_put, aten.index_put_, aten._index_put_impl_, aten.index_add, aten.index_add_,
    aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.slice_scatter,
    aten.select_scatter, aten.masked_scatter, aten.masked_select,
    # reductions, scans and sorts
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.argmax, aten.argmin,
    aten.logsumexp, aten.prod, aten.any, aten.all, aten.cumsum, aten.cumprod, aten.sort,
    aten.topk, aten.argsort, aten.searchsorted, aten.norm, aten.linalg_vector_norm,
    aten._softmax, aten._log_softmax, aten.var_mean, aten.var,
    # concatenation, padding
    aten.cat, aten.stack, aten.constant_pad_nd, aten.pad,
}

# the operators of torch itself; any other namespace is a custom operator
# (JAX's custom-call), whose bytes are mandatory
_TORCH_NAMESPACES = {"aten", "prim", "prims", "_c10d_functional", "c10d"}

# allocations that write nothing
_FREE_OPS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten.detach, aten.lift_fresh, aten._local_scalar_dense}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _tensors(a)


def dot_flops(func, args, out) -> float:
    """2 x |result| x contracted extent of a product op (0 for any other)."""
    packet = func.overloadpacket
    at = _DOT_OPS.get(packet)
    if at is None:
        return 0.0
    lhs = args[at]
    if packet is aten.addbmm:  # sums its batch into one (M, N) result
        return 2.0 * lhs.shape[0] * out.numel() * lhs.shape[-1]
    return 2.0 * out.numel() * lhs.shape[-1]


def op_bytes(func, args, kwargs, out) -> int:
    """Operand plus result bytes of one op; a region write counts what it
    writes twice; views and allocations move nothing."""
    packet = func.overloadpacket
    if packet in _FREE_OPS or func.is_view or not any(True for _ in _tensors(out)):
        return 0
    at = _REGION_WRITES.get(packet)
    if at is not None:
        moved = 2 * tensor_bytes(args[at]) if at < len(args) else 0
        extra = [a for i, a in enumerate(args) if i not in (0, at)]
        return moved + sum(tensor_bytes(t) for t in _tensors(extra))
    return (sum(t.numel() * t.element_size() for t in _tensors(list(args)))
            + sum(t.numel() * t.element_size() for t in _tensors(out)))


class CostCounter(LocalOpMode):
    """FLOPs, mandatory bytes, all bytes and collectives of the local ops
    run under it; ``report()`` is ``analyze_hlo``'s dictionary."""

    def __init__(self, also=(), weights: dict | None = None):
        super().__init__(also)
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_upper = 0.0
        self.coll: list = []  # collective records, weights named after ``weights``
        self.custom: dict = {}  # custom operator -> calls
        self.origin = WeightOrigin(weights) if weights is not None else None

    def on_op(self, func, args, kwargs, out) -> None:
        if self.origin is not None:
            self.origin.on_op(func, args, kwargs, out)
        hit = classify(func, args, self.origin)
        if hit is not None:
            self.coll.append(hit)
            return
        self.flops += dot_flops(func, args, out)
        b = op_bytes(func, args, kwargs, out)
        self.bytes_upper += b
        if func.namespace not in _TORCH_NAMESPACES:
            name = func.overloadpacket._qualified_op_name
            self.custom[name] = self.custom.get(name, 0) + 1
            self.bytes += b
        elif func.overloadpacket in _MEMORY_OPS:
            self.bytes += b

    def report(self) -> dict:
        coll = collective_bytes(self.coll)
        coll.pop("count")
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "bytes_upper": self.bytes_upper,
            "collectives": coll,
            "unknown_trip_loops": 0,
        }


def analyze(fn, *args, **kwargs) -> dict:
    """``analyze_hlo``'s counterpart: the per-device cost of one call of
    ``fn(*args, **kwargs)``, counted as it runs."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.report()
