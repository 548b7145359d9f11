"""2-D Ising model on a periodic lattice, sampled by checkerboard Gibbs —
the PyTorch port of ``repro.workloads.ising``.

Each site is one 1-bit word (spin s = 2 * word - 1) and one engine step
is one checkerboard half-sweep: all sites of one colour draw their new
value in parallel from p(s_i = +1 | neighbours) = sigmoid(2 (beta * sum_j
s_j + field)).  ``IsingModel`` is a conditional target: it exposes
``conditional_logit`` and ``update_mask`` (the ``gibbs`` update rule's
contract) and ``logit_spec``, the form in which the CUDA kernel takes the
same conditional.  ``conditional_logit`` calls ``logit_spec``, so the
scan executor and the kernels' plain versions compute one formula.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.gibbs.ref import IsingLogit, checkerboard
from repro_torch.samplers.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class IsingModel:
    """Ferromagnetic 2-D Ising model on a periodic H x W lattice, in
    natural units: log p(s) = beta * sum_<ij> s_i s_j + field * sum_i s_i
    + const.  The 2-D zero-field critical point is beta_c ~ 0.4407.

    ``beta`` and ``field`` enter every formula rounded to float32, as the
    JAX model's python floats do when they meet float32 arrays."""

    height: int
    width: int
    beta: float = 0.35
    field: float = 0.0

    nbits = 1
    table = None
    supports_fused_gibbs = True

    def __post_init__(self):
        if self.height < 2 or self.width < 2:
            raise ValueError(
                f"lattice must be at least 2x2, got {self.height}x{self.width}"
            )

    # --- gibbs update-rule contract ------------------------------------

    @property
    def logit_spec(self) -> IsingLogit:
        return IsingLogit(self.beta, self.field)

    def conditional_logit(self, state: torch.Tensor) -> torch.Tensor:
        """Per-site logit of s_i = +1 given the current neighbours:
        2 (beta * neighbour-spin sum + field)."""
        return self.logit_spec(state)

    def update_mask(self, shape: tuple, parity, device=None) -> torch.Tensor:
        """Checkerboard colour active at this half-sweep parity."""
        return checkerboard(*shape[-2:], device=device) == parity

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        return words

    # --- observables ----------------------------------------------------

    def magnetization(self, states: torch.Tensor) -> torch.Tensor:
        """Mean spin per lattice: (..., H, W) words -> (...,) in [-1, 1]."""
        s = 2.0 * states.to(torch.float32) - 1.0
        n = torch.tensor(self.height * self.width, dtype=torch.float32, device=s.device)
        return s.sum(dim=(-2, -1)) / n

    def energy(self, states: torch.Tensor) -> torch.Tensor:
        """-(beta * sum_<ij> s_i s_j + field * sum_i s_i), each periodic
        bond counted once (right + down neighbours)."""
        s = 2.0 * states.to(torch.float32) - 1.0
        bonds = s * torch.roll(s, -1, -2) + s * torch.roll(s, -1, -1)
        spec = self.logit_spec
        beta = torch.tensor(spec.beta, dtype=torch.float32, device=s.device)
        field = torch.tensor(spec.field, dtype=torch.float32, device=s.device)
        return -(beta * bonds.sum(dim=(-2, -1)) + field * s.sum(dim=(-2, -1)))

    def random_init(self, key: torch.Tensor, batch: int) -> torch.Tensor:
        """Infinite-temperature start: i.i.d. fair spins, (B, H, W) words;
        a (C, 2) stack of keys gives (C, B, H, W)."""
        planes = prng.bernoulli(key, 0.5, (batch, self.height, self.width))
        return planes.to(torch.int64)


def _key(key, device: torch.device) -> torch.Tensor:
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    return key.to(device=device, dtype=torch.int64) & 0xFFFFFFFF


def build(
    key,
    randomness: str = "cim",
    backend: str = "auto",
    smoke: bool = False,
    height: int | None = None,
    width: int | None = None,
    batch: int | None = None,
    beta: float | None = None,
    field: float = 0.0,
    n_steps: int | None = None,
    chunk_steps: int = 32,
    num_chains: int = 1,
    collect: str = "all",
    device=None,
):
    """Assemble the Ising workload (see ``workloads.WorkloadRun``).

    The JAX builder's arguments and defaults, plus ``device`` (the
    engine's device rule: the card unless ``"cpu"`` is asked for).  Inits
    are counter-derived per chain, ``random_init(chain_key(key, c))``, so
    chain c of a C-chain build equals a solo build, inits included.
    """
    from repro_torch import samplers, workloads  # workloads imports this module

    device = resolve_device(device)
    height = height or (8 if smoke else 16)
    width = width or (8 if smoke else 16)
    batch = batch or (2 if smoke else 4)
    n_steps = n_steps or (48 if smoke else 1024)
    model = IsingModel(
        height=height, width=width, beta=0.35 if beta is None else beta, field=field,
    )
    engine = samplers.MHEngine(
        samplers.EngineConfig(
            update="gibbs", randomness=randomness, execution=backend,
            chunk_steps=chunk_steps, num_chains=num_chains, collect=collect,
        ),
        device=device,
    )
    init = model.random_init(samplers.chain_keys(_key(key, device), num_chains), batch)
    return workloads.WorkloadRun(
        name="ising",
        engine=engine,
        target=model,
        init_words=init[0] if num_chains == 1 else init,
        n_steps=n_steps,
        burn_in=n_steps // 4,
        series_fn=model.magnetization,
        meta={
            "lattice": f"{height}x{width}",
            "batch": batch,
            "num_chains": num_chains,
            "beta": model.beta,
            "field": field,
            "nbits": 1,
            "statistic": "magnetization",
        },
    )
