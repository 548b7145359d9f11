# The distributed layer of the PyTorch port: the logical-axis sharding
# rules on a torch DeviceMesh (sharding), the int8 error-feedback cross-pod
# gradient reduction (compression), and the training loop's host-only fault
# handling (fault.PreemptionHandler, straggler.StragglerWatchdog).  The JAX
# package's HLO tools (hlo_analysis, hlo_cost) read XLA HLO and have no
# counterpart here.

from repro_torch.distributed import compression, sharding  # noqa: F401
from repro_torch.distributed.fault import PreemptionHandler  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    spec_for,
)
from repro_torch.distributed.straggler import StragglerWatchdog  # noqa: F401
