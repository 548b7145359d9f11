# Chain-axis sharding of the PyTorch port: the "chains" logical-axis rule
# of repro.distributed.sharding, resolved on a torch DeviceMesh; and the
# training loop's host-only fault handling (fault.PreemptionHandler,
# straggler.StragglerWatchdog).  The LLM rules (batch, heads, vocab, ...)
# and the gradient compression wait for ROADMAP.md queue 1 item 10g.

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    spec_for,
)
