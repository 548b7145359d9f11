# Chain diagnostics of the PyTorch port: integrated autocorrelation time,
# effective sample size and split-R-hat over a scalar statistic of the
# chain, batch and streaming, and the replica-exchange swap statistics
# that the health monitor reads.  Copies of the numpy-only modules of
# repro.diagnostics.

from repro_torch.diagnostics.chain_stats import (  # noqa: F401
    autocorrelation,
    effective_sample_size,
    integrated_autocorr_time,
    split_rhat,
    summarize,
)
from repro_torch.diagnostics.streaming import (  # noqa: F401
    StreamingChainStats,
    summarize_stream,
)
from repro_torch.diagnostics.swap_stats import SwapStats  # noqa: F401
