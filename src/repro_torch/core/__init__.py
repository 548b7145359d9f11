# The paper's primary contribution in PyTorch: a behavioural + algorithmic
# twin of the SRAM compute-in-memory MCMC macro (the port of repro.core).
#
#   bitcell       pseudo-read stochasticity model, BFR(CVDD, T)
#   msxor         multi-stage XOR debiasing (lambda recursion + folds)
#   uniform_rng   accurate [0,1] RNG (reset -> pseudo-read -> MSXOR -> pack)
#   proposal      bit-flip proposal + symmetric transfer matrix
#   metropolis    Metropolis-Hastings API (wraps repro_torch.samplers engine)
#   macro         compartment-parallel macro + 28 nm energy/time ledger
#   energy        calibrated per-op energy/latency model (paper Fig. 14/16)
#   targets       GMM / MGD / categorical targets + grid codecs
#   token_sampler softmax-free MCMC token sampling for LLM decode

from repro_torch.core import (  # noqa: F401
    bitcell,
    energy,
    macro,
    metropolis,
    msxor,
    proposal,
    targets,
    token_sampler,
    uniform_rng,
)
from repro_torch.core.macro import CIMMacro, MacroConfig  # noqa: F401
from repro_torch.core.metropolis import MHConfig, run_chain  # noqa: F401
