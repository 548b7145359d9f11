# Checkpoints of the PyTorch port in the JAX package's on-disk format
# (step_%08d/, leaf_%05d.npy, manifest.json with sha256 hashes), and the
# bit-exact resumable-run driver built on them.

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointConfig,
    CheckpointManager,
    checkpoint_nbytes,
    latest_step,
    load_checkpoint,
    load_checkpoint_tree,
    run_state,
    save_checkpoint,
)
from repro_torch.checkpoint.resume import run_resumable  # noqa: F401
