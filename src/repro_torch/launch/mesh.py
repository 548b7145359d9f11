"""Production meshes and the sampler engine's scale-out mesh — the port
of ``repro.launch.mesh``.

Meshes (the JAX package's):
  single-pod:  (16, 16)      dimensions ("data", "model")   = 256 devices
  multi-pod:   (2, 16, 16)   dimensions ("pod", "data", "model") = 512 devices

``alt_mesh`` builds the same-count variants (e.g. (32, 8) to restore
attention TP for 40/24/20-head archs).  Each is a ``DeviceMesh`` over the
ranks of the initialised default process group, which must hold exactly
as many ranks (one device each); a smaller group raises ``ValueError``
naming the world size the mesh needs.

The port runs one process per device (``torch.distributed``: ``nccl``
on cards, ``gloo`` on the CPU).  ``make_chains_mesh`` starts no process
group: the caller initialises it, with its address, world size and rank,
and the mesh spans its ranks.  The CLIs do that through
``torchrun_group``, from the environment ``torchrun`` sets.  Every
builder is a function, so importing the module touches no device.
"""

from __future__ import annotations

import contextlib
import gc
import os


def _grid_mesh(shape: tuple, names: tuple, device_type: str):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..N-1 of the default
    process group, row-major, its dimensions named ``names``."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"a {shape} mesh {names} needs a process group of world size {need}; "
                         f"this one has {have}")
    return DeviceMesh(device_type, np.arange(need).reshape(shape).tolist(),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid_mesh(shape, axes, device_type)


def alt_mesh(data: int, model: int, *, pods: int = 1, device_type: str = "cuda"):
    """Same-device-count variants, e.g. alt_mesh(32, 8); with ``pods`` > 1
    a ("pod", "data", "model") mesh."""
    if pods > 1:
        return _grid_mesh((pods, data, model), ("pod", "data", "model"), device_type)
    return _grid_mesh((data, model), ("data", "model"), device_type)


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


@contextlib.contextmanager
def torchrun_group(device_type: str = "cuda"):
    """The default process group of a ``torchrun`` launch, for the block.

    With ``WORLD_SIZE`` > 1 in the environment (``torchrun`` sets it with
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), pins
    this process to card ``LOCAL_RANK``, initialises the group — ``nccl``
    on cards, ``gloo`` under ``device_type="cpu"`` — and destroys it on
    exit; yields this process's rank.  Without ``torchrun`` it starts
    nothing and yields 0.  The block must hold no mesh or group when it
    ends (keep them in a function it calls): a gloo group object that
    outlives ``destroy_process_group`` aborts the process at exit.  A
    ``cuda`` request with no card raises the engine's error first: there
    is no fallback to the CPU.
    """
    from repro_torch.samplers.engine import resolve_device

    resolve_device(device_type)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield 0
        return
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    try:
        yield dist.get_rank()
    finally:
        gc.collect()  # group objects the block dropped, held only in cycles
        dist.destroy_process_group()
