# The PyTorch port of the CIM MCMC sampler (the JAX package `repro`, which
# stays as the reference).  It imports torch and numpy, never jax or repro;
# its entry points run on a CUDA device unless the caller passes
# device="cpu".  Table targets run through the hand-written CUDA kernels in
# csrc/, built with nvcc at first use (kernels/_build.py).

from repro_torch import prng, samplers  # noqa: F401
