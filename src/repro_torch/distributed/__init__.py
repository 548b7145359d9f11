# Chain-axis sharding of the PyTorch port: the "chains" logical-axis rule
# of repro.distributed.sharding, resolved on a torch DeviceMesh.  The LLM
# rules (batch, heads, vocab, ...) wait for the LLM scaffolding
# (ROADMAP.md queue 1, item 10).

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    spec_for,
)
