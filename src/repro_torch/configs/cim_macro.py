"""The paper's own artefact: the 256 kb CIM MCMC macro configuration.

Not an LM architecture — this config parameterises ``repro.core.macro``
exactly as §6.1/Fig. 13(a) of the paper describe the taped-out design.
"""

from repro_torch.core.macro import MacroConfig


def config() -> MacroConfig:
    return MacroConfig(
        n_compartments=64,   # §5.2
        rows=64,
        cols=64,
        nbits=4,             # base precision; expandable to 64 (§5.1)
        cvdd_pseudo_read=0.5,  # V — p_BFR ~ 45 % (§3.1)
        temp_c=25.0,
        rng_bit_width=8,     # accurate [0,1] RNG output width (§4.2)
        rng_stages=3,        # MSXOR stages (§4.2)
        burn_in=500,         # §2.1
    )


def smoke_config() -> MacroConfig:
    return MacroConfig(
        n_compartments=8, rows=16, cols=16, nbits=4, burn_in=50
    )
