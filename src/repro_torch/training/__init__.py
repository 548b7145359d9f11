"""Train and serve step factories — the port of ``repro.training``."""

from repro_torch.training.step import (  # noqa: F401
    TrainStepConfig,
    make_decode_sample_step,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
