"""The sampler engine's scale-out mesh — the port of
``repro.launch.mesh.make_chains_mesh``.

The port runs one process per device (``torch.distributed``: ``nccl``
on cards, ``gloo`` on the CPU).  Nothing here starts a process group:
the caller initialises it, with its address, world size and rank, and
the mesh spans its ranks.  Every builder is a function, so importing the
module touches no device.
"""

from __future__ import annotations


def make_chains_mesh(num_chains: int | None = None, *, devices=None, device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` whose dimension is named ``"data"``, over the
    ranks ``devices`` (default: every rank of the initialised default
    process group), for sharding the chains axis by the "chains" rule.

    Returns ``None`` when sharding cannot help — fewer than 2 devices (no
    process group counts as one), or a known chain count below 2 — so
    callers can pass the result straight to ``RunPlan(mesh=...)``.
    ``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if num_chains is not None and num_chains < 2:
        return None
    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        devices = list(range(dist.get_world_size()))
    devices = list(devices)
    if len(devices) < 2:
        return None
    return DeviceMesh(device_type, devices, mesh_dim_names=("data",))


def mesh_chip_count(mesh) -> int:
    """Devices in ``mesh``."""
    return mesh.size()
