"""The synthetic token pipeline — the port of ``repro.data``."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    MarkovSource,
    SyntheticTokenPipeline,
    UniformSource,
)
