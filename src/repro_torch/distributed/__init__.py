# The distributed layer of the PyTorch port: the logical-axis sharding
# rules on a torch DeviceMesh (sharding), the int8 error-feedback cross-pod
# gradient reduction (compression), the training loop's host-only fault
# handling (fault.PreemptionHandler, straggler.StragglerWatchdog), and the
# dry run's per-device counters (hlo_analysis: collective bytes; hlo_cost:
# FLOPs and bytes), which read the op stream a step issues where the JAX
# package reads XLA's HLO.

from repro_torch.distributed import compression, sharding  # noqa: F401
from repro_torch.distributed.fault import PreemptionHandler  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    spec_for,
)
from repro_torch.distributed.straggler import StragglerWatchdog  # noqa: F401
