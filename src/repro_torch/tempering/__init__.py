# Parallel tempering and simulated annealing in PyTorch (the port of
# repro.tempering, the same public names): the algorithm tier above the
# sampler engine.
#
#   Ladder          beta schedules + per-replica scaled targets (p^beta
#                   by scaling the table, the log-prob or the Gibbs logit
#                   spec's scale — the kernels take it as an operand)
#   ReplicaExchange even/odd adjacent-pair swaps at absolute-step
#                   boundaries, uniforms from the run's own
#                   RandomnessBackend, so tempered runs are bit-identical
#                   across executors and chunkings
#   Annealer        monotone cooling schedules with a streaming
#                   best-state tracker

from repro_torch.tempering.anneal import AnnealResult, Annealer  # noqa: F401
from repro_torch.tempering.exchange import (  # noqa: F401
    ReplicaExchange,
    TemperedResult,
)
from repro_torch.tempering.ladder import (  # noqa: F401
    Ladder,
    TemperedLattice,
    base_log_prob,
    scaled_target,
)
