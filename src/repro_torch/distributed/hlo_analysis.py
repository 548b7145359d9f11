"""Collective-traffic accounting from the op stream a step issues — the
port of ``repro.distributed.hlo_analysis``.

The JAX package parses the compiled HLO text for collectives.  Eager
PyTorch has no HLO: a step issues its collectives one by one through the
dispatcher, so a dispatch mode sees each of them.  ``CollectiveCounter``
records every collective that runs under it:

  * the ``_c10d_functional.*`` ops DTensor issues, inside its own op
    dispatch and in ``redistribute`` (a dispatch mode returns
    ``NotImplemented`` for DTensor arguments, so DTensor desugars first
    and the mode sees the local ops and collectives of this rank);
  * the explicit ``c10d.*`` collectives (``dist.all_reduce`` and the
    like) of ``sharding.local_region``, ``moe_ffn_ep`` and
    ``compression.compressed_pmean``.

Each record is ``(kind, operand bytes, operand shape, weight)``:
``weight`` names the parameter the operand was made from alone (a shard,
a view, a cast or a padded copy of it; ``WeightOrigin``), else None, so
a gathered weight is told from gathered activations of the same shape.
``collective_bytes(records)`` sums them into JAX's dictionary.  Bytes
convention (per participating device, as JAX's): the operand bytes of
this rank, whatever the kind (all-gather: the shard sent; reduce-scatter
and all-reduce: the whole operand); the roofline applies the algorithm
factor.  A collective over a group of one rank moves nothing and is not
recorded (XLA emits none).  The kinds are JAX's five: a broadcast or a
send counts as ``collective-permute``.

``LocalOpMode`` is the dispatch mode the port's dry-run counters share:
it sees the local ops of this rank, and not the ops of DTensor's
bookkeeping (the propagation of an op's metadata on global shapes, run
once per op signature and cached; the shard offsets), which are not part
of the step and run outside any fake tensor mode.
"""

from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op name -> (kind, index of the operand argument)
_KIND = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("collective-permute", 0),
    "_c10d_functional.broadcast_": ("collective-permute", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.broadcast_": ("collective-permute", 0),
    "c10d.send": ("collective-permute", 0),
}


def tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor or nested lists/tuples)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(a) for a in x)
    return 0


def _group_size(args) -> int | None:
    """The size of the process group a collective names (a group name, or
    a ``ProcessGroup`` that reaches the dispatcher boxed); None when none
    is found."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return None


def tensor_shapes(x) -> tuple:
    """The shape of a tensor, or the shapes of the tensors in nested
    lists/tuples, as tuples of ints."""
    if isinstance(x, torch.Tensor):
        return tuple(int(d) for d in x.shape)
    if isinstance(x, (list, tuple)):
        shapes = [tensor_shapes(a) for a in x]
        return shapes[0] if len(shapes) == 1 else tuple(shapes)
    return ()


def classify(func, args, origin: WeightOrigin | None = None) -> tuple | None:
    """``(kind, operand bytes, operand shape, weight)`` of a collective op
    (``weight``: the parameter ``origin`` names the operand after, or
    None), or None for any other op (and for a collective over one
    rank)."""
    name = func.overloadpacket._qualified_op_name.replace("::", ".")
    entry = _KIND.get(name)
    if entry is None:
        return None
    if _group_size(args) == 1:
        return None
    kind, at = entry
    weight = origin.name_of(args[at]) if origin is not None else None
    return kind, tensor_bytes(args[at]), tensor_shapes(args[at]), weight


def collective_bytes(records) -> dict:
    """Sum operand bytes per collective kind over ``records`` ((kind,
    bytes, shape, weight) records, as ``CollectiveCounter`` keeps them).

    Returns {kind: bytes, ..., "total": bytes, "count": n_ops}.
    """
    out: dict = collections.defaultdict(int)
    count = 0
    for kind, nbytes, *_ in records:
        out[kind] += nbytes
        count += 1
    out["total"] = sum(out[k] for k in COLLECTIVES if k in out)
    out["count"] = count
    return dict(out)


# --- the dispatch mode the counters share ------------------------------------

_BOOKKEEPING = [0]  # depth of DTensor bookkeeping now running
_MARKED: list = [0, []]  # modes entered, and the (owner, name, original) wrapped


def _bookkeeping():
    """(owner, attribute) of DTensor's bookkeeping that runs ops of its
    own: the metadata propagation (the op once on fake tensors of the
    global shapes) and the shard offsets, which torch may compute with
    small index tensors.  Only the first must exist."""
    from torch.distributed.tensor import DTensor, _utils, placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    if not hasattr(prop, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError("DTensor's sharding propagator has no _propagate_tensor_meta_"
                           "non_cached: the dry-run counters cannot tell its ops from a step's")
    out = [(prop, "_propagate_tensor_meta_non_cached")]
    for owner, name in ((_utils, "_compute_local_shape_and_global_offset"),
                        (placement_types._StridedShard, "local_shard_size_and_offset")):
        if hasattr(owner, name):
            out.append((owner, name))
    return out


def _marked(fn):
    """``fn`` run as bookkeeping: outside any fake tensor mode (its index
    tensors are real and small) and unseen by the counters."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        _BOOKKEEPING[0] += 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _BOOKKEEPING[0] -= 1

    return run


@contextlib.contextmanager
def dtensor_bookkeeping():
    """While the block runs, DTensor's bookkeeping is marked (``_marked``):
    a fake tensor mode must not reach it (torch may read its index
    tensors' values), and the counters must not count it."""
    if _MARKED[0] == 0:
        for owner, name in _bookkeeping():
            raw = (owner.__dict__ if isinstance(owner, type) else vars(owner)).get(name)
            if isinstance(raw, (staticmethod, classmethod)):
                setattr(owner, name, type(raw)(_marked(raw.__func__)))
            else:
                setattr(owner, name, _marked(getattr(owner, name)))
            _MARKED[1].append((owner, name, raw))
    _MARKED[0] += 1
    try:
        yield
    finally:
        _MARKED[0] -= 1
        if _MARKED[0] == 0:
            for owner, name, raw in reversed(_MARKED[1]):
                if raw is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, raw)
            _MARKED[1].clear()


_DEVICE = torch.ops.prim.device.default


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode over the local ops of this rank: DTensor arguments
    are left to DTensor (which runs its local ops and collectives under
    the mode), and the ops of DTensor's bookkeeping are not seen.
    Subclasses implement ``on_op(func, args, kwargs, out)``; the modes in
    ``also`` see the same ops through this one (one dispatch layer for
    several counters, not one each)."""

    def __init__(self, also=()):
        super().__init__()
        self.also = tuple(also)

    def __enter__(self):
        self._marks = contextlib.ExitStack()
        self._marks.enter_context(dtensor_bookkeeping())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func is _DEVICE:  # metadata, asked of nearly every op
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _BOOKKEEPING[0]:
            self.on_op(func, args, kwargs, out)
            for other in self.also:
                other.on_op(func, args, kwargs, out)
        return out

    def on_op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _flat_tensors(a)
    elif isinstance(x, dict):
        for a in x.values():
            yield from _flat_tensors(a)


class WeightOrigin:
    """Which of this rank's local tensors are made from one weight alone:
    the local tensors of ``named`` ({name: tensor or DTensor}) and every
    output of an op whose tensor inputs all come from that weight (a
    view, a cast, a pad, a copy, a slice), keyed by storage until it is
    freed.  An op that also reads another tensor (a product, the
    optimizer's update) makes no weight."""

    def __init__(self, named: dict):
        from torch.distributed.tensor import DTensor

        self.names: dict = {}
        for name, t in named.items():
            self._tag(t.to_local() if isinstance(t, DTensor) else t, name)

    def _tag(self, t, name: str) -> None:
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.names:
            self.names[key] = name
            weakref.finalize(st, self.names.pop, key, None)

    def name_of(self, x) -> str | None:
        """The weight the tensors of ``x`` are made from, or None."""
        names = {self.names.get(t.untyped_storage()._cdata) if t.layout == torch.strided
                 else None for t in _flat_tensors(x)}
        return names.pop() if len(names) == 1 else None

    def on_op(self, func, args, kwargs, out) -> None:
        name = self.name_of((args, kwargs))
        if name is not None:
            for t in _flat_tensors(out):
                self._tag(t, name)


class CollectiveCounter(LocalOpMode):
    """Records ``(kind, operand bytes, operand shape, weight)`` for every
    collective this rank issues under it, naming the operand's weight
    after ``weights`` ({name: parameter}) where given; ``report()`` is
    ``collective_bytes`` of them."""

    def __init__(self, also=(), weights: dict | None = None):
        super().__init__(also)
        self.records: list = []
        self.origin = WeightOrigin(weights) if weights is not None else None

    def on_op(self, func, args, kwargs, out) -> None:
        hit = classify(func, args, self.origin)
        if hit is not None:
            self.records.append(hit)
        if self.origin is not None:
            self.origin.on_op(func, args, kwargs, out)

    def report(self) -> dict:
        return collective_bytes(self.records)
