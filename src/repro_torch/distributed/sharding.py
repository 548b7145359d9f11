"""Logical-axis sharding rules — the "chains" rule of
``repro.distributed.sharding``, on a torch ``DeviceMesh``.

The engine names its chain axis ``"chains"``; this module maps it onto
the mesh dimensions the rules table lists, keeping only those the mesh
has and whose extent divides the axis (a chain count the mesh does not
divide falls back to replication rather than padding).  A spec is a
tuple with one entry per logical axis — a mesh dimension name, a tuple
of names, or None (replicated) — with trailing Nones dropped, as the JAX
package's ``PartitionSpec`` is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any

DEFAULT_RULES: dict[str, Any] = {
    "chains": ("pod", "data"),  # sampler-engine chain axis (DP-like)
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = tuple(sorted(DEFAULT_RULES.items()))

    def as_dict(self) -> dict:
        return dict(self.rules)


def _mesh_axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _filter_entry(entry, mesh, dim_size: int | None, used: set = frozenset()):
    """Resolve one logical axis to the mesh dimensions present, unused and
    dividing ``dim_size``."""
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    kept = []
    extent = 1
    for name in names:
        if name not in (mesh.mesh_dim_names or ()) or name in used:
            continue
        size = _mesh_axis_size(mesh, name)
        if dim_size is not None and dim_size % (extent * size) != 0:
            continue
        kept.append(name)
        extent *= size
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(
    logical_axes: tuple,
    rules: ShardingRules = ShardingRules(),
    shape: tuple | None = None,
    mesh=None,
) -> tuple | None:
    """Map logical axes to mesh dimensions under ``mesh`` (None: no mesh,
    no spec — the port has no ambient mesh)."""
    if mesh is None:
        return None
    table = rules.as_dict()
    entries = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        entry = table.get(ax) if ax is not None else None
        dim = None if shape is None else shape[i]
        # a mesh dimension may appear at most once in a spec
        resolved = _filter_entry(entry, mesh, dim, used)
        if resolved is not None:
            used.update(resolved if isinstance(resolved, tuple) else (resolved,))
        entries.append(resolved)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)
