"""Continuous-batching MCMC serving tier in PyTorch (the port of
``repro.serving``, the same public names).

A sampling request names a workload, a step budget, a seed and a
collection mode; the serving tier packs concurrent requests into the
slot axis of one advance call a chunk:

  * ``scheduler`` — the request queue + slot assignment
    (``ServeRequest``, ``FIFOQueue``, ``Scheduler``, ``latency_summary``);
  * ``executor``  — the packed batch (``PackedExecutor``): per-slot
    ``step0`` offsets keep every request on the stream of its solo run,
    so joining mid-flight is bit-exact; under ``pallas`` all slots of a
    class fold into one call of the CUDA kernels a chunk;
  * ``dispatch``  — the packed advance calls, the deletion of the old
    carry after each call (``poison_donated``) and the host/device
    overlap (``SegmentPipeline``, ``to_host``).

Executors run on ``device``, the card unless ``device="cpu"`` is asked
for; ``mesh`` (a 1-D ``DeviceMesh``, one process per device) shards a
scan class's slot axis across ranks.
"""

from repro_torch.serving.executor import PackedExecutor
from repro_torch.serving.scheduler import (
    FIFOQueue,
    Scheduler,
    ServeRequest,
    latency_summary,
)

__all__ = [
    "FIFOQueue",
    "PackedExecutor",
    "Scheduler",
    "ServeRequest",
    "latency_summary",
]
