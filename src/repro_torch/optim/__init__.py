"""The optimizer and its schedules — the port of ``repro.optim``."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    opt_state_axes,
    zero_axes_tree,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
