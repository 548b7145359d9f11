# The sampler engine in PyTorch: the port of repro.samplers, with the MH
# and Gibbs update rules.  Build a RunPlan, call MHEngine.submit, continue
# from the returned RunHandle.  Under execution="pallas" table targets run
# through the CUDA kernels of csrc/mh.cu and lattice models (workloads/)
# through those of csrc/gibbs.cu on a CUDA device, and through their plain
# versions on the CPU.  The exports are the JAX package's: the autotuner
# (autotune.py) and the deprecated run_engine shim included.

from repro_torch.samplers.autotune import (
    TuneResult,
    autotune_config,
    autotune_engine,
)
from repro_torch.samplers.engine import (
    EngineConfig,
    EngineResult,
    MHEngine,
    SamplerEngine,
    kept_count,
    parse_collect,
    resolve_execution,
    run_engine,
)
from repro_torch.samplers.plan import (
    RunHandle,
    RunPlan,
    submit,
)
from repro_torch.samplers.randomness import (
    CIMRandomness,
    FusedRandomness,
    HostRandomness,
    RandomnessBackend,
    chain_key,
    chain_keys,
    make_randomness_backend,
)
from repro_torch.samplers.targets import (
    CallableTarget,
    TableTarget,
    TopKTarget,
    logits_target,
)

__all__ = [
    "TuneResult",
    "autotune_config",
    "autotune_engine",
    "run_engine",
    "RunPlan",
    "RunHandle",
    "submit",
    "MHEngine",
    "SamplerEngine",
    "EngineConfig",
    "EngineResult",
    "kept_count",
    "parse_collect",
    "resolve_execution",
    "RandomnessBackend",
    "HostRandomness",
    "CIMRandomness",
    "FusedRandomness",
    "make_randomness_backend",
    "chain_key",
    "chain_keys",
    "CallableTarget",
    "TableTarget",
    "TopKTarget",
    "logits_target",
]
