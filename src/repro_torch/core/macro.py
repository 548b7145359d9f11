"""The CIM macro — compartment-parallel MCMC with energy/time accounting.

The PyTorch counterpart of ``repro.core.macro``: a behavioural twin of the
paper's 256 kb macro (§4-§6): 64 compartments of 64x64 bitcells, each
running an independent MH chain in lock-step, a shared accurate-[0,1]
RNG, and the three working modes (memory / block-wise RNG / CIM copy).
The sampling path is ``metropolis._run_chain_impl`` on the port's sampler
engine; the macro layer adds the compartment geometry, the
operating-condition -> p_BFR mapping, and the 28 nm energy/timing ledger.

Metric definitions (paper Fig. 16): the energy/time ledger charges
*every* chain step (burn-in and thinned-away steps cost real energy),
while ``energy_per_sample_pj`` and ``throughput_samples_per_s`` are
normalised by the *kept* sample count.  They are outputs of the 28 nm
model (``core.energy``), not measurements of the device the chains run
on.  The chains run on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bitcell, energy, metropolis, uniform_rng


class MacroMode(enum.Enum):
    MEMORY = "memory"            # plain SRAM R/W
    BLOCK_RNG = "block_rng"      # pseudo-read block random generation
    CIM_COPY = "cim_copy"        # in-memory copy


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    n_compartments: int = energy.N_COMPARTMENTS
    rows: int = 64
    cols: int = 64
    nbits: int = 4                       # 4..64 via column-group ganging (§5.1)
    cvdd_pseudo_read: float = bitcell.PSEUDO_READ_CVDD
    temp_c: float = bitcell.NOMINAL_TEMP_C
    rng_bit_width: int = 16
    rng_stages: int = 3
    burn_in: int = 500
    thin: int = 1

    def __post_init__(self):
        if self.nbits > 64:
            raise ValueError("expandable precision tops out at 64 bits (§5.1)")
        groups_needed = -(-self.nbits // 4)
        if groups_needed > self.cols // 4:
            raise ValueError("sample wider than a compartment row")

    @property
    def p_bfr(self) -> float:
        return float(bitcell.bit_flip_rate(self.cvdd_pseudo_read, self.temp_c))

    @property
    def sample_nbits(self) -> int:
        return min(self.nbits, 32)

    def mh_config(self) -> metropolis.MHConfig:
        return metropolis.MHConfig(
            nbits=self.sample_nbits,
            p_bfr=self.p_bfr,
            rng_p_bfr=self.p_bfr,
            rng_stages=self.rng_stages,
            rng_bit_width=self.rng_bit_width,
            burn_in=self.burn_in,
            thin=self.thin,
            randomness="cim",            # the macro IS the CIM pipeline
        )


@dataclasses.dataclass(frozen=True)
class MacroRunStats:
    n_samples: int
    n_steps: int
    acceptance_rate: float
    energy_pj: float                     # 28 nm model output
    modeled_time_s: float                # 28 nm model output
    energy_per_sample_pj: float          # total energy / KEPT samples
    throughput_samples_per_s: float      # KEPT samples / modeled time


class CIMMacro:
    """Compartment-parallel MCMC sampler with the paper's cost model."""

    def __init__(self, config: MacroConfig = MacroConfig(), device=None):
        self.config = config
        self.device = device  # None: the CUDA card (the engine's device rule)

    @property
    def p_bfr(self) -> float:
        return self.config.p_bfr

    def uniform_rng_config(self) -> uniform_rng.UniformRNGConfig:
        return uniform_rng.UniformRNGConfig(
            p_bfr=self.config.p_bfr,
            n_stages=self.config.rng_stages,
            bit_width=self.config.rng_bit_width,
        )

    def sample(
        self,
        key,
        log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
        n_samples: int,
        init_words=None,
    ) -> tuple[np.ndarray, MacroRunStats]:
        """Draw >= ``n_samples`` words; returns (samples as uint32 numpy,
        stats).

        Samples are drawn across all compartments in lock-step, so the kept
        count per chain is ceil(n_samples / n_compartments).
        """
        cfg = self.config
        per_chain = -(-n_samples // cfg.n_compartments)
        result = metropolis._run_chain_impl(
            key,
            log_prob_fn,
            cfg.mh_config(),
            n_samples=per_chain,
            chain_shape=(cfg.n_compartments,),
            init_words=init_words,
            device=self.device,
        )
        samples = result.samples.reshape(-1)[:n_samples].cpu().numpy().astype(np.uint32)

        n_steps_total = int(result.n_steps) * cfg.n_compartments
        n_accepted = int(result.final.accept_count.sum())
        n_kept = int(samples.size)
        ledger = energy.EnergyLedger(
            n_steps=n_steps_total,
            n_accepted=n_accepted,
            nbits=cfg.nbits,
            n_chains=cfg.n_compartments,
        )
        stats = MacroRunStats(
            n_samples=n_kept,
            n_steps=n_steps_total,
            acceptance_rate=float(result.acceptance_rate),
            energy_pj=ledger.energy_pj,
            modeled_time_s=ledger.time_s,
            energy_per_sample_pj=ledger.energy_pj / max(1, n_kept),
            throughput_samples_per_s=(
                n_kept / ledger.time_s if ledger.time_s > 0 else float("inf")
            ),
        )
        return samples, stats

    def mh_config(self) -> metropolis.MHConfig:
        return self.config.mh_config()

    def sample_points(
        self,
        key,
        density,
        codec,
        n_samples: int,
    ) -> tuple[np.ndarray, MacroRunStats]:
        """Sample a continuous density through a GridCodec (Fig. 17
        workloads); returns float32 numpy points (n_samples, dim)."""
        from repro_torch.core import targets as _targets

        log_prob_fn = _targets.discretized_target(density, codec)
        words, stats = self.sample(key, log_prob_fn, n_samples)
        pts = codec.decode(torch.from_numpy(words.astype(np.int64))).numpy()
        return pts, stats

