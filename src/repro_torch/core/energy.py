"""Calibrated 28 nm energy & timing model of the CIM macro — paper §6.4/§6.5.

A copy of ``repro.core.energy`` (pure Python) for the PyTorch port, which
imports nothing of the JAX package.  Its numbers are the model's, for the
paper's 28 nm macro: none of them is a time or an energy of the device
the port runs on.

All constants are the paper's measured values (Fig. 16(a), Fig. 14, §6.1).
Derived quantities are validated against every number quoted in the paper:

  * accepted sample:   0.5065 pJ       (§6.4)
  * rejected sample:   0.5547 pJ       (§6.4)
  * 30-40 % acceptance: 0.533-0.540 pJ (§6.4; we get 0.5402-0.5354, see note)
  * 4-bit throughput:  166.7 M samples/s  (§6.5, 6 ns/iteration)
  * >=1e7 samples/s up to 32-bit, sub-2x slowdown per bit doubling (Fig 16(b))

Model notes (documented deviations):
  * The per-sample energy decomposes as
      E_accept(4b) = E_rng + E_copy + E_read + E_u/64 + E_calc
                   = 79.1 + 47.5 + 343.1 + 3.67 + 33.1 = 506.5 fJ,
    which reproduces the paper's 0.5065 pJ exactly; E_calc = 33.1 fJ is the
    one fitted residual (the paper does not itemise the accept/reject logic).
  * Rejection adds one extra in-memory copy (+ WL overhead): +48.2 fJ.
  * R/W and copy energy/latency scale with ceil(bits/4) column groups
    (§5.1 "separate transmission" over 4-column groups); block-RNG energy
    scales with active bitcells but its *latency* does not (§6.5: WLs of any
    width open simultaneously).
"""

from __future__ import annotations

import dataclasses
import math

# --- per-operation energies, femtojoules (Fig. 16(a)) ---------------------
E_WRITE_FJ_PER_4B = 372.6
E_READ_FJ_PER_4B = 343.1
E_BLOCK_RNG_FJ_PER_4B = 79.1
E_COPY_FJ_PER_4B = 47.5
E_UNIFORM_RNG_FJ_PER_8B = 234.6   # shared by all 64 compartments (§6.1)
E_CALC_FJ = 33.1                  # fitted: accept/reject digital logic
E_REJECT_EXTRA_FJ = 48.2          # re-copy previous value (0.5547-0.5065 pJ)

# --- per-operation latencies, nanoseconds (Fig. 14 timing diagram) --------
T_WRITE_NS = 1.0
T_RNG_NS = 1.0        # independent of bit width (parallel WLs, §6.5)
T_COPY_NS = 2.0       # per 4-column group
T_READ_NS = 1.0       # per 4-column group
T_CALC_NS = 1.0
T_GUARD_NS = 1.0      # WL switch / precharge guard band

N_COMPARTMENTS = 64   # §5.2: 64 compartments of 64x64 bitcells
MACRO_CAPACITY_KB = 256
CORE_AREA_MM2 = 0.1967


def _groups(nbits: int) -> int:
    """Number of 4-column groups ganged for an ``nbits`` sample (§5.1)."""
    if not 1 <= nbits <= 64:
        raise ValueError(f"nbits must be in [1, 64], got {nbits}")
    return max(1, math.ceil(nbits / 4))


def energy_accepted_fj(nbits: int = 4) -> float:
    g = _groups(nbits)
    return (
        E_BLOCK_RNG_FJ_PER_4B * g
        + E_COPY_FJ_PER_4B * g
        + E_READ_FJ_PER_4B * g
        + E_UNIFORM_RNG_FJ_PER_8B / N_COMPARTMENTS
        + E_CALC_FJ
    )


def energy_rejected_fj(nbits: int = 4) -> float:
    # extra in-memory copy rewrites the previous value over the rejected one
    extra = E_REJECT_EXTRA_FJ * (_groups(nbits) / _groups(4))
    return energy_accepted_fj(nbits) + extra


def energy_per_sample_fj(accept_ratio: float, nbits: int = 4) -> float:
    """Expected energy per chain step at the given acceptance ratio (§6.4)."""
    if not 0.0 <= accept_ratio <= 1.0:
        raise ValueError(f"accept_ratio must be in [0,1], got {accept_ratio}")
    return accept_ratio * energy_accepted_fj(nbits) + (
        1.0 - accept_ratio
    ) * energy_rejected_fj(nbits)


def iteration_time_ns(nbits: int = 4) -> float:
    """Per-sample loop period (Fig. 14): 6 ns at 4-bit => 166.7 M samples/s."""
    g = _groups(nbits)
    return T_RNG_NS + T_CALC_NS + g * (T_READ_NS + T_COPY_NS) + T_GUARD_NS


def throughput_per_chain(nbits: int = 4) -> float:
    """Samples/s of one compartment chain (the paper's headline number)."""
    return 1e9 / iteration_time_ns(nbits)


def throughput_aggregate(nbits: int = 4, n_compartments: int = N_COMPARTMENTS) -> float:
    """Aggregate chain-steps/s with all compartments in lock-step (§5.2)."""
    return n_compartments * throughput_per_chain(nbits)


def power_w(nbits: int = 4, accept_ratio: float = 0.35) -> float:
    """Single-chain average power = energy/sample x chain rate.

    Reproduces the paper's §6.6 quote of 0.157 mW (GMM) / 0.152 mW (MGD) at
    32-bit: 37 M samples/s x ~3.8-4.2 pJ/sample ~ 0.15 mW.
    """
    return energy_per_sample_fj(accept_ratio, nbits) * 1e-15 * throughput_per_chain(
        nbits
    )


def time_for_samples_s(
    n_samples: int, nbits: int = 32, n_compartments: int = N_COMPARTMENTS
) -> float:
    """Macro wall time to emit ``n_samples`` with compartment parallelism.

    Fig. 17(c): 1e6 32-bit samples in ~4e-4 s ("within 1e-3 s" in the paper).
    """
    return n_samples / throughput_aggregate(nbits, n_compartments)


@dataclasses.dataclass(frozen=True)
class EnergyLedger:
    """Accumulated energy/time for a concrete MCMC run (macro accounting)."""

    n_steps: int = 0
    n_accepted: int = 0
    nbits: int = 4
    n_chains: int = 1

    def add(self, n_steps: int, n_accepted: int) -> "EnergyLedger":
        return dataclasses.replace(
            self,
            n_steps=self.n_steps + n_steps,
            n_accepted=self.n_accepted + n_accepted,
        )

    @property
    def n_rejected(self) -> int:
        return self.n_steps - self.n_accepted

    @property
    def energy_pj(self) -> float:
        return (
            self.n_accepted * energy_accepted_fj(self.nbits)
            + self.n_rejected * energy_rejected_fj(self.nbits)
        ) * 1e-3

    @property
    def time_s(self) -> float:
        per_chain_steps = math.ceil(self.n_steps / max(1, self.n_chains))
        return per_chain_steps * iteration_time_ns(self.nbits) * 1e-9

    @property
    def energy_per_sample_pj(self) -> float:
        return self.energy_pj / max(1, self.n_steps)
