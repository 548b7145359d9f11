# Chain diagnostics of the PyTorch port: integrated autocorrelation time,
# effective sample size and split-R-hat over a scalar statistic of the
# chain, batch and streaming.  Copies of the numpy-only modules of
# repro.diagnostics; the replica-exchange statistics (swap_stats) wait for
# the tempering slice (ROADMAP.md queue 1, item 7).

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
