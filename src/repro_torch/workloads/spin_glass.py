"""±J spin glass / MAX-CUT on a periodic lattice — the PyTorch port of
``repro.workloads.spin_glass``.

A 2-D Edwards–Anderson model: every bond carries its own coupling
(bimodal ±J by default), so the landscape is frustrated.  One site is one
1-bit word and one engine step one checkerboard half-sweep.  A periodic
lattice is bipartite only for even H and W, so the model requires them.
MAX-CUT rides the reduction J = -w: ``SpinGlass.maxcut`` draws signed
integer weights and ``cut_value`` turns a configuration into its cut
weight.  ``exhaustive_ground_state`` solves lattices of up to 20 sites.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.gibbs.ref import SpinGlassLogit, checkerboard
from repro_torch.samplers.engine import resolve_device


class SpinGlass:
    """2-D spin glass with per-bond couplings on a periodic H x W lattice.

    ``j_right[i, j]`` couples site (i, j) to (i, j+1 mod W); ``j_down[i,
    j]`` couples (i, j) to (i+1 mod H, j).  log p(s) = sum_bonds J_ij s_i
    s_j + field * sum_i s_i + const.  The couplings are float32 tensors on
    one device; the lattice state must live there too."""

    nbits = 1
    table = None
    supports_fused_gibbs = True

    def __init__(self, j_right, j_down, field: float = 0.0):
        self.j_right = torch.as_tensor(j_right, dtype=torch.float32).contiguous()
        self.j_down = torch.as_tensor(j_down, dtype=torch.float32).to(
            self.j_right.device).contiguous()
        if self.j_right.ndim != 2 or self.j_right.shape != self.j_down.shape:
            raise ValueError(
                f"couplings must be two equal (H, W) arrays, got "
                f"{tuple(self.j_right.shape)} and {tuple(self.j_down.shape)}"
            )
        self.height, self.width = map(int, self.j_right.shape)
        if self.height < 2 or self.width < 2 or self.height % 2 or self.width % 2:
            raise ValueError(
                "periodic checkerboard Gibbs needs an even, >= 2x2 lattice "
                f"(odd wrap-around breaks bipartiteness), got "
                f"{self.height}x{self.width}"
            )
        self.field = float(field)
        self.maxcut_reduction = False  # set by the maxcut constructor

    @property
    def device(self) -> torch.device:
        return self.j_right.device

    @classmethod
    def bimodal(
        cls, key, height: int, width: int, j: float = 1.0,
        p_ferro: float = 0.5, field: float = 0.0,
    ) -> "SpinGlass":
        """±J couplings: each bond is +j with prob ``p_ferro``, else -j."""
        k_r, k_d = prng.split(key)
        j32 = torch.tensor(j, dtype=torch.float32, device=key.device)

        def sign(k):
            planes = prng.bernoulli(k, p_ferro, (height, width))
            return 2.0 * planes.to(torch.float32) - 1.0

        return cls(j32 * sign(k_r), j32 * sign(k_d), field=field)

    @classmethod
    def maxcut(
        cls, key, height: int, width: int, max_weight: int = 3, signed: bool = True,
    ) -> "SpinGlass":
        """(Signed) MAX-CUT on the lattice graph: J = -w, zero field,
        ``cut_value`` enabled.  Integer weight magnitudes in [1,
        max_weight]; ``signed`` draws a random sign per edge (unsigned
        MAX-CUT on the bipartite lattice is the trivial checkerboard)."""
        k_r, k_d, k_sr, k_sd = prng.split(key, 4)

        def weights(k_mag, k_sign):
            w = prng.randint(k_mag, (height, width), 1, max_weight + 1).to(torch.float32)
            if signed:
                w = torch.where(prng.bernoulli(k_sign, 0.5, (height, width)), -w, w)
            return w

        model = cls(-weights(k_r, k_sr), -weights(k_d, k_sd), field=0.0)
        model.maxcut_reduction = True
        return model

    # --- gibbs update-rule contract ------------------------------------

    @property
    def logit_spec(self) -> SpinGlassLogit:
        return SpinGlassLogit(self.j_right, self.j_down, self.field)

    def conditional_logit(self, state: torch.Tensor) -> torch.Tensor:
        """Per-site logit of s_i = +1 given the neighbours: 2 (sum_j J_ij
        s_j + field), each incident bond with its own J."""
        return self.logit_spec(state)

    def update_mask(self, shape: tuple, parity, device=None) -> torch.Tensor:
        """Checkerboard colour active at this half-sweep parity."""
        return checkerboard(*shape[-2:], device=device) == parity

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        return words

    # --- observables / optimisation ------------------------------------

    def energy(self, states: torch.Tensor) -> torch.Tensor:
        """E(s) = -(sum J_r s s_right + sum J_d s s_down + field sum s),
        each bond counted once; p ∝ exp(-E)."""
        s = 2.0 * states.to(torch.float32) - 1.0
        bonds = (
            self.j_right * s * torch.roll(s, -1, -1)
            + self.j_down * s * torch.roll(s, -1, -2)
        )
        field = torch.tensor(self.logit_spec.field, dtype=torch.float32, device=s.device)
        return -(bonds.sum(dim=(-2, -1)) + field * s.sum(dim=(-2, -1)))

    def cut_value(self, states: torch.Tensor) -> torch.Tensor:
        """Cut weight under the MAX-CUT reduction w = -J: (W_total -
        E(s)) / 2, maximal at the ground state."""
        if not self.maxcut_reduction or self.field != 0.0:
            raise ValueError(
                "cut_value needs a zero-field MAX-CUT model (use SpinGlass.maxcut)"
            )
        w_total = -(self.j_right.sum() + self.j_down.sum())
        return 0.5 * (w_total - self.energy(states))

    def random_init(self, key: torch.Tensor, batch: int) -> torch.Tensor:
        """Infinite-temperature start: i.i.d. fair spins, (B, H, W) words;
        a (C, 2) stack of keys gives (C, B, H, W)."""
        planes = prng.bernoulli(key, 0.5, (batch, self.height, self.width))
        return planes.to(torch.int64)


def exhaustive_ground_state(model: SpinGlass, chunk: int = 1 << 14) -> tuple[float, np.ndarray]:
    """Brute-force (ground energy, one ground state) for H * W <= 20 sites."""
    n = model.height * model.width
    if n > 20:
        raise ValueError(f"exhaustive enumeration capped at 20 sites, got {n}")
    bit = np.arange(n, dtype=np.int64)
    best_e, best_state = np.inf, None
    for start in range(0, 1 << n, chunk):
        words = np.arange(start, min(start + chunk, 1 << n), dtype=np.int64)
        states = ((words[:, None] >> bit) & 1).reshape(-1, model.height, model.width)
        e = model.energy(torch.from_numpy(states).to(model.device)).cpu().numpy()
        i = int(np.argmin(e))
        if e[i] < best_e:
            best_e, best_state = float(e[i]), states[i].astype(np.uint32)
    return best_e, best_state


def build(
    key,
    randomness: str = "cim",
    backend: str = "auto",
    smoke: bool = False,
    height: int | None = None,
    width: int | None = None,
    batch: int | None = None,
    j: float = 1.0,
    p_ferro: float = 0.5,
    field: float = 0.0,
    maxcut: bool = False,
    n_steps: int | None = None,
    chunk_steps: int = 32,
    num_chains: int = 1,
    collect: str = "all",
    device=None,
):
    """Assemble the spin-glass workload (see ``workloads.WorkloadRun``).

    The JAX builder's arguments and defaults, plus ``device``.  Couplings
    come from the first half of ``split(key)``, inits from the second,
    counter-derived per chain as for the other workloads.
    """
    from repro_torch import samplers, workloads  # workloads imports this module
    from repro_torch.workloads.ising import _key

    device = resolve_device(device)
    height = height or (4 if smoke else 8)
    width = width or (4 if smoke else 8)
    batch = batch or (2 if smoke else 4)
    n_steps = n_steps or (48 if smoke else 768)
    k_bonds, k_init = prng.split(_key(key, device))
    if maxcut:
        model = SpinGlass.maxcut(k_bonds, height, width)
    else:
        model = SpinGlass.bimodal(k_bonds, height, width, j=j, p_ferro=p_ferro, field=field)
    engine = samplers.MHEngine(
        samplers.EngineConfig(
            update="gibbs", randomness=randomness, execution=backend,
            chunk_steps=chunk_steps, num_chains=num_chains, collect=collect,
        ),
        device=device,
    )
    init = model.random_init(samplers.chain_keys(k_init, num_chains), batch)
    return workloads.WorkloadRun(
        name="spin_glass",
        engine=engine,
        target=model,
        init_words=init[0] if num_chains == 1 else init,
        n_steps=n_steps,
        burn_in=n_steps // 4,
        series_fn=model.energy,
        meta={
            "lattice": f"{height}x{width}",
            "batch": batch,
            "num_chains": num_chains,
            "maxcut": maxcut,
            "j": j,
            "p_ferro": p_ferro,
            "field": field,
            "nbits": 1,
            "statistic": "energy",
        },
    )
