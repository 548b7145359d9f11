"""Logical-axis sharding rules (DP / TP / EP / SP / ZeRO) — the port of
``repro.distributed.sharding``, on a torch ``DeviceMesh``.

Model code annotates tensors with *logical* axis names; this module maps
them onto mesh dimensions per a rules table, filtered by what the active
mesh provides and by divisibility (a logical dim not divisible by its
mesh-dimension extent falls back to replication).  A spec is a tuple
with one entry per logical axis — a mesh dimension name, a tuple of
names, or None (replicated) — with trailing Nones dropped, as the JAX
package's ``PartitionSpec`` is built.

Baseline rules:
  batch   -> ("pod", "data")     data parallelism (pod axis = outer DP)
  heads / kv_heads / ffn / vocab / experts / ssm_heads -> "model"   (TP / EP)
  seq_ctx -> "data"              context parallelism for long-context decode
  everything else  -> replicated

ZeRO-1: optimizer states / master params additionally shard their largest
replicated dim over ("pod", "data") via ``add_zero_axes``.

JAX's auto regions are DTensors here.  ``use_mesh(mesh)`` is the
counterpart of ``jax.set_mesh``: the ambient mesh ``active_mesh()``
returns, under which plain tensors count as replicated (DTensor's
implicit replication), so the model code calls ``shard`` without
threading a mesh.  ``shard(x, axes)`` is ``x.redistribute(...)`` to the
spec's placements (a plain ``x``, held whole by every rank, is cut to
them first); without a mesh it returns ``x`` itself.  JAX's manual
regions (``shard_map``) are explicit collectives on local tensors:
inside ``manual_axes(names)`` those mesh dimensions are skipped, as
JAX skips Manual axes, and ``shard`` places tensors on the sub-mesh of
the others.  ``AbstractMesh`` gives ``spec_for`` and ``add_zero_axes``
a mesh without process groups.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

Axes = tuple  # tuple[str | None | tuple[str, ...], ...]


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_heads": "model",
    "chains": ("pod", "data"),  # sampler-engine chain axis (DP-like)
    "seq_ctx": "data",      # context parallelism (long-context decode)
    "seq_sp": "model",      # sequence parallelism on the residual stream
    # replicated logical axes
    "seq": None,
    "cache_seq": None,   # decode KV cache seq (arch override -> "model"/"data")
    "embed": None,
    "embed_tp": "model",  # input-embedding d-sharding (gather stays local)
    "vocab_rep": None,    # input-embedding vocab axis (replicated)
    "head_dim": None,
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "expert_cap": None,
    "frames": None,
    "patches": None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = tuple(sorted(DEFAULT_RULES.items()))

    def as_dict(self) -> dict:
        return dict(self.rules)

    def replace(self, **updates) -> "ShardingRules":
        d = self.as_dict()
        d.update(updates)
        return ShardingRules(rules=tuple(sorted(d.items())))


# --- active-rules context ----------------------------------------------------
# Model code calls shard(x, logical_axes) without threading rules; callers
# install per-arch rule patches (cfg.sharding_overrides) around a run.

_ACTIVE_RULES: list = [ShardingRules()]


def get_rules() -> ShardingRules:
    return _ACTIVE_RULES[-1]


class use_rules:
    """Context manager installing sharding rules for the enclosed run."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()
        return False


def rules_for_config(cfg) -> ShardingRules:
    """Base rules + per-arch overrides (cfg.sharding_overrides tuple)."""
    overrides = dict(getattr(cfg, "sharding_overrides", ()) or ())
    return ShardingRules().replace(**overrides) if overrides else ShardingRules()


# --- meshes --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and dimension names, without devices or process
    groups: ``jax.sharding.AbstractMesh``'s counterpart."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} do not match names {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axis_names(mesh) -> tuple:
    """The dimension names of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape[axis]
    return mesh.size(mesh.mesh_dim_names.index(axis))


_MESHES: list = []
_MANUAL: list = []


def active_mesh():
    """The mesh installed by ``use_mesh``; None when not set."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """``jax.set_mesh``: make ``mesh`` the ambient mesh for the block.  On
    a ``DeviceMesh`` plain tensors mixed with DTensors count as replicated
    (every rank holds the same value), as every array under a JAX mesh is
    global."""
    _MESHES.append(mesh)
    try:
        if isinstance(mesh, AbstractMesh):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield mesh
    finally:
        _MESHES.pop()


@contextlib.contextmanager
def manual_axes(names):
    """A manual region over the mesh dimensions ``names`` (``shard_map``'s
    ``axis_names``): the code inside works on local tensors over them and
    reduces over them with explicit collectives; ``spec_for`` skips them."""
    _MANUAL.append(frozenset(names))
    try:
        yield
    finally:
        _MANUAL.pop()


def _manual_axes(mesh) -> set:
    """Mesh dimensions the current manual region covers."""
    names = set(mesh_axis_names(mesh))
    out = set()
    for region in _MANUAL:
        out |= region & names
    return out


def _filter_entry(entry, mesh, dim_size: int | None, used: set = frozenset()):
    """Resolve one logical axis to mesh dimensions present, unused and
    dividing ``dim_size``.  Dimensions the current manual region covers
    are skipped, as JAX skips Manual axes."""
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    present = mesh_axis_names(mesh)
    manual = _manual_axes(mesh)
    kept = []
    extent = 1
    for name in names:
        if name not in present or name in used or name in manual:
            continue
        size = mesh_axis_size(mesh, name)
        if dim_size is not None and dim_size % (extent * size) != 0:
            continue
        kept.append(name)
        extent *= size
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(
    logical_axes: Axes,
    rules: ShardingRules = ShardingRules(),
    shape: tuple | None = None,
    mesh=None,
) -> tuple | None:
    """Map logical axes to a spec under ``mesh`` (default: the active
    mesh); None without a mesh."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    table = rules.as_dict()
    entries = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        entry = table.get(ax) if ax is not None else None
        dim = None if shape is None else shape[i]
        # a mesh dimension may appear at most once in a spec: skip used names
        resolved = _filter_entry(entry, mesh, dim, used)
        if resolved is not None:
            used.update(resolved if isinstance(resolved, tuple) else (resolved,))
        entries.append(resolved)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def whole(t):
    """A DTensor's whole value (every rank of its mesh holds it after); a
    plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def sub_mesh(mesh, names: tuple):
    """The sub-mesh of ``mesh`` over the dimensions ``names`` that holds
    this rank (``mesh`` itself when ``names`` are all of them)."""
    if tuple(names) == mesh_axis_names(mesh):
        return mesh
    return mesh[tuple(names)]


def auto_mesh(mesh):
    """The sub-mesh of the dimensions no manual region covers."""
    manual = _manual_axes(mesh)
    return sub_mesh(mesh, tuple(n for n in mesh_axis_names(mesh) if n not in manual))


def named_sharding(mesh, spec, shape: tuple | None = None) -> list:
    """A spec as DTensor placements, one per dimension of ``mesh``: each
    named dimension shards the tensor dimension whose entry names it,
    the others replicate.  A tensor dimension over several mesh
    dimensions is split in mesh order (pod-major), as JAX splits it; an
    entry naming them in another order raises ``ValueError``.  Given the
    tensor's ``shape``, a dimension of one element stays whole (it can
    only be split over mesh dimensions of one rank, and DTensor's view
    rules refuse to reshape a split singleton)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec or ()):
        if entry is None or (shape is not None and shape[dim] == 1):
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def shard(x, logical_axes: Axes, rules: ShardingRules | None = None):
    """``with_sharding_constraint`` by logical axes: ``x`` redistributed to
    the spec's placements on the active mesh (its sub-mesh outside the
    current manual region); ``x`` itself without a mesh."""
    spec = spec_for(logical_axes, rules or get_rules(), shape=tuple(x.shape))
    if spec is None or isinstance(active_mesh(), AbstractMesh):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = auto_mesh(active_mesh())
    placements = named_sharding(mesh, spec, tuple(x.shape))
    if not isinstance(x, DTensor):  # a plain tensor every rank holds whole
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    elif x.device_mesh != mesh:
        raise ValueError(f"a tensor on mesh {x.device_mesh} constrained on {mesh}")
    return x.redistribute(mesh, placements)


class _SumInto(torch.autograd.Function):
    """The identity on the global value, laid out as ``placements`` both
    ways: the forward pass redistributes ``x`` (a ``Partial`` sum reduced
    by an all-reduce) and the backward pass brings the gradient to the
    same placements, so neither direction is left to DTensor's choice."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def reduce_into(x, logical_axes: Axes, rules: ShardingRules | None = None):
    """``shard`` for a partial sum, with the gradient pinned too: JAX's
    ``psum`` into a layout, whose transpose hands the gradient back as the
    layout places it.  A plain ``x`` goes to ``shard``; a DTensor placed
    so already is returned as it is."""
    if not is_dtensor(x):
        return shard(x, logical_axes, rules)
    spec = spec_for(logical_axes, rules or get_rules(), shape=tuple(x.shape))
    placements = tuple(named_sharding(x.device_mesh, spec, tuple(x.shape)))
    if tuple(x.placements) == placements:
        return x
    return _SumInto.apply(x, placements)


def split_placements(x, dims: tuple = (0,)) -> list | None:
    """``x``'s placements with only the splits of its dimensions ``dims``
    kept (default: the leading, batch, dimension: the layout of a
    row-local region); None for a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return None
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in x.placements]


def local_extent(shape, mesh, placements):
    """(local sizes, global offsets) of this rank's block of a tensor of
    ``shape`` split by ``placements`` on ``mesh``, as DTensor's ``Shard``
    cuts it (``torch.chunk``: chunks of ceil(n / ranks), in mesh order);
    in Python, so it runs under a fake tensor mode too."""
    from torch.distributed.tensor import Shard

    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim < len(shape):
            d, n = p.dim, mesh.size(i)
            chunk = -(-size[d] // n)
            lo = min(coord[i] * chunk, size[d])
            off[d] += lo
            size[d] = min(lo + chunk, size[d]) - lo
    return size, off


def local_region(fn, placements, *args, shared: int = 0, out_placements=None):
    """``fn`` on local tensors, the port's ``local_map``: every DTensor
    argument is redistributed to ``placements`` on its mesh and replaced
    by its local tensor (plain arguments pass as they are), and every
    tensor ``fn`` returns (in nested tuples) becomes a DTensor with those
    placements, or with ``out_placements`` where given (a ``Partial``
    there makes the output a sum over ranks).  ``placements=None`` keeps
    each DTensor argument as it is placed; its gradient is then a partial
    sum over the mesh dimensions that split the output, or make it a
    partial sum, and not the argument.  The last ``shared`` arguments
    (weights every rank's share reads whole) are brought whole instead,
    and their gradients come back as partial sums over the mesh
    dimensions that ``placements`` split.  Gradients flow through both
    crossings.  Without a DTensor argument ``fn`` runs as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    whole = [Replicate()] * mesh.ndim
    out_placements = out_placements or placements
    first_shared = len(args) - shared
    local = []
    for i, a in enumerate(args):
        if not isinstance(a, DTensor):
            local.append(a)
        elif placements is None:
            grad = [Partial() if (isinstance(o, Shard) or o.is_partial())
                    and not isinstance(p, Shard) else p
                    for p, o in zip(a.placements, out_placements)]
            local.append(a.to_local(grad_placements=grad))
        elif i < first_shared:
            local.append(a.redistribute(mesh, placements).to_local())
        else:
            partial = [Partial() if isinstance(p, Shard) else Replicate() for p in placements]
            local.append(a.redistribute(mesh, whole).to_local(grad_placements=partial))

    def wrap(out):
        if isinstance(out, tuple):
            return tuple(wrap(o) for o in out)
        return DTensor.from_local(out, mesh, out_placements, run_check=False)

    return wrap(fn(*local))


def add_zero_axes(
    logical_axes: Axes,
    shape: tuple,
    rules: ShardingRules = ShardingRules(),
    mesh=None,
    zero_axes: tuple = ("pod", "data"),
) -> Axes:
    """ZeRO-1: extend a param's axes so optimizer state also shards over DP.

    Picks the first replicated dim divisible by the full DP extent and maps
    it to a synthetic logical axis bound to ``zero_axes``.
    """
    mesh = mesh or active_mesh()
    if mesh is None:
        return logical_axes
    table = rules.as_dict()
    dp = 1
    for name in zero_axes:
        if name in mesh_axis_names(mesh):
            dp *= mesh_axis_size(mesh, name)
    if dp <= 1:
        return logical_axes
    out = list(logical_axes)
    for i, ax in enumerate(out):
        entry = table.get(ax) if ax is not None else None
        if entry is None and shape[i] % dp == 0:
            out[i] = "_zero"
            return tuple(out)
    return logical_axes


ZERO_RULES_PATCH = {"_zero": ("pod", "data")}


def rules_with_zero(rules: ShardingRules = ShardingRules()) -> ShardingRules:
    return rules.replace(**ZERO_RULES_PATCH)


def leaf_axes(axes, ndim: int) -> tuple:
    """A leaf's logical axes for a tensor of ``ndim`` dimensions: the JAX
    tree stacks a layer stack's leaves on a leading ``"layers"`` axis
    (``lm.LM.param_axes`` names it), the port keeps one tensor a layer."""
    axes = tuple(axes)
    if len(axes) == ndim + 1 and axes[0] == "layers":
        return axes[1:]
    return axes


def tree_specs(axes_tree: dict, rules: ShardingRules, shapes_tree: dict | None = None,
               mesh=None) -> dict:
    """Map ``{name: logical axes}`` (``lm.LM.param_axes``) to specs; with
    ``shapes_tree`` (``{name: tensor or shape}``) the divisibility filter
    applies to each leaf's own shape."""
    if shapes_tree is None:
        return {n: spec_for(tuple(a), rules, mesh=mesh) for n, a in axes_tree.items()}
    out = {}
    for n, a in axes_tree.items():
        shape = tuple(getattr(shapes_tree[n], "shape", shapes_tree[n]))
        out[n] = spec_for(leaf_axes(a, len(shape)), rules, shape=shape, mesh=mesh)
    return out


def distribute_params(module, mesh, rules: ShardingRules | None = None, axes: dict | None = None):
    """Every parameter of ``module`` (held whole and alike by every rank)
    made a DTensor on ``mesh``, cut to the spec of its logical axes
    (``axes``, default ``module.param_axes``) under ``rules`` (default
    the active ones); the parameters keep their names, dtypes and
    ``requires_grad``.  Returns the module."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Replicate

    rules = rules or get_rules()
    axes = axes if axes is not None else module.param_axes
    owners = dict(module.named_modules())
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        spec = spec_for(leaf_axes(axes[name], p.ndim), rules, shape=tuple(p.shape), mesh=mesh)
        whole = DTensor.from_local(p.detach(), mesh, [Replicate()] * mesh.ndim, run_check=False)
        value = nn.Parameter(whole.redistribute(mesh, named_sharding(mesh, spec, p.shape)),
                             requires_grad=p.requires_grad)
        value.logical_axes = getattr(p, "logical_axes", None)
        owners[owner_name]._parameters[leaf] = value
    return module
