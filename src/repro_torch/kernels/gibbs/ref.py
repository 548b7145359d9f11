"""Plain PyTorch versions of the two checkerboard Gibbs kernels.

``gibbs_chain_ref`` is the counterpart of ``repro.kernels.gibbs.ref`` and
the plain version of ``csrc/gibbs.cu:gibbs_band_kernel<OperandDraw>``;
``gibbs_chain_fused_ref`` draws the uniforms the fused kernel draws
in-kernel, through ``repro_torch.kernels.rng``, and runs the same
half-sweeps: the plain version of ``gibbs_band_kernel<FusedDraw>``.  Both return
int32 spins and flip counts, as the kernels do.  The CPU path of the
wrappers and the card-side parity checks run these.

A Pallas kernel traces the model's ``logit_fn`` as a closure; a CUDA
kernel cannot, so the two conditionals that reach it are spelled out
here, ``IsingLogit`` and ``SpinGlassLogit``, each in the JAX model's
operation order.  The lattice models' ``conditional_logit`` calls them,
so the scan executor, these plain versions and the kernels share one
formula.  Every product in the model's own logit is exact (``beta``
times an even integer of at most 4 in magnitude, a coupling times a spin
of ±1), so a fused multiply-add could not change it; only the order of
the sums matters, and it is kept.  Each spec also carries a ``scale``,
multiplied in last (``scale * logit``, as the JAX package's
``TemperedLattice`` multiplies ``float32(beta)`` into its base's logit):
1 for a plain model, where the multiply is exact, and the replica's beta
for a tempered one, where it is not — so the kernels are built without
contraction.

The flip is ``u < sigmoid(logit)`` with ``sigmoid(x) = 1 / (1 + exp(-x))``,
the formula XLA expands ``jax.nn.sigmoid`` into.  Implementations of
``exp`` differ by a few ULP, so two executors may part only where ``u``
lies within a few ULP of the flip probability: a *tie event*
(``tie_events``), which the parity tests assert absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import rng

TIE_ULPS = 4  # the largest gap measured between XLA's and torch's 1/(1+exp(-x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in this order, as XLA computes ``lax.logistic``
    and as the kernels do; never ``torch.sigmoid``."""
    return 1.0 / (1.0 + torch.exp(-x))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX's weak typing rounds a python
    float that meets a float32 array."""
    return float(np.float32(x))


def _spins(state: torch.Tensor) -> torch.Tensor:
    return 2.0 * state.to(torch.float32) - 1.0


def _scaled(scale: float, logit: torch.Tensor) -> torch.Tensor:
    """``float32(scale) * logit``, the scale a float32 operand filled in on
    the logit's device (no copy from the host)."""
    return torch.full((), scale, dtype=torch.float32, device=logit.device) * logit


@dataclasses.dataclass(frozen=True)
class IsingLogit:
    """``IsingModel.conditional_logit``: 2 (beta * neighbour sum + field),
    neighbours summed north, south, west, east on the periodic lattice,
    times ``scale`` last."""

    beta: float
    field: float = 0.0
    scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "beta", _f32(self.beta))
        object.__setattr__(self, "field", _f32(self.field))
        object.__setattr__(self, "scale", _f32(self.scale))

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        s = _spins(state)
        nb = (
            ((torch.roll(s, 1, -2) + torch.roll(s, -1, -2)) + torch.roll(s, 1, -1))
            + torch.roll(s, -1, -1)
        )
        beta = torch.full((), self.beta, dtype=torch.float32, device=s.device)
        field = torch.full((), self.field, dtype=torch.float32, device=s.device)
        return _scaled(self.scale, 2.0 * (beta * nb + field))


@dataclasses.dataclass(frozen=True, eq=False)
class SpinGlassLogit:
    """``SpinGlass.fused_logit``: 2 (sum_j J_ij s_j + field), summed east,
    west, south, north, each bond with its own coupling, times ``scale``
    last.  ``j_right`` and ``j_down`` are (H, W) float32 tensors on the
    lattice's device."""

    j_right: torch.Tensor
    j_down: torch.Tensor
    field: float = 0.0
    scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "field", _f32(self.field))
        object.__setattr__(self, "scale", _f32(self.scale))

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        s = _spins(state)
        jr, jd = self.j_right, self.j_down
        nb = (
            (
                jr * torch.roll(s, -1, -1)
                + torch.roll(jr, 1, -1) * torch.roll(s, 1, -1)
            )
            + jd * torch.roll(s, -1, -2)
        ) + torch.roll(jd, 1, -2) * torch.roll(s, 1, -2)
        field = torch.full((), self.field, dtype=torch.float32, device=s.device)
        return _scaled(self.scale, 2.0 * (nb + field))


def checkerboard(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W) colour of each site: (row + col) % 2."""
    row = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    return (row + col) % 2


def _per_lattice(x, b: int, device) -> torch.Tensor:
    """An int or a (B,) tensor as (B, 1, 1) int64, for broadcasting."""
    return torch.as_tensor(x, dtype=torch.int64, device=device).expand(b).reshape(b, 1, 1)


def _half_sweep(state, u_k, logit, active):
    """One half-sweep: ``u < sigmoid(logit)`` written on the active colour
    only, every logit from the state before the sweep."""
    new = (u_k < sigmoid(logit(state))).to(torch.int32)
    return torch.where(active, new, state)


def gibbs_chain_ref(
    init: torch.Tensor,  # (B, H, W) {0, 1} spins (int32 or int64)
    u: torch.Tensor,     # (K, B, H, W) float32 uniforms
    logit,               # IsingLogit | SpinGlassLogit
    parity0=0,           # int or (B,) per-lattice starting parity
):
    """K checkerboard half-sweeps; half-sweep k updates the sites with
    ``(row + col) % 2 == (parity0 + k) % 2``.

    Returns (samples (K, B, H, W) int32 spins, flips (B, H, W) int32), the
    kernels' dtypes.
    """
    state = init.to(torch.int32)
    b, h, w = state.shape
    checker = checkerboard(h, w, state.device)
    par0 = _per_lattice(parity0, b, state.device)
    samples = torch.empty(u.shape, dtype=torch.int32, device=state.device)
    nflips = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    for k in range(u.shape[0]):
        nxt = _half_sweep(state, u[k], logit, checker == (par0 + k) % 2)
        nflips += (nxt != state).to(torch.int32)
        samples[k] = state = nxt
    return samples, nflips


def fused_uniforms(k0b, k1b, t0b, k: int, shape: tuple, lat_b: int) -> torch.Tensor:
    """The (B, H, W) uniforms half-sweep ``k`` of the fused kernel draws:
    ``uniform_at(step_key(k0b[i], k1b[i], t0b[i] + k), site)`` with
    ``site = (i % lat_b) * H * W + h * W + w``."""
    b, h, w = shape
    dev = k0b.device
    s0, s1 = rng.step_key(k0b, k1b, (rng.u32(t0b) + k) & rng.MASK32)
    lattice = torch.arange(b, dtype=torch.int64, device=dev) % lat_b
    site = lattice[:, None, None] * (h * w) + rng.site_index((h, w), device=dev)
    return rng.uniform_at(s0.reshape(b, 1, 1), s1.reshape(b, 1, 1), site)


def gibbs_chain_fused_ref(init, k0b, k1b, t0b, logit, n_steps: int, lat_b: int):
    """The fused kernel's chain: half-sweep k draws ``fused_uniforms`` and
    takes the parity ``(t0b + k) % 2`` of its absolute step (mod 2^32).
    Returns int32 samples and flips, as ``gibbs_chain_ref``."""
    state = init.to(torch.int32)
    b, h, w = state.shape
    checker = checkerboard(h, w, state.device)
    t0 = _per_lattice(rng.u32(t0b), b, state.device)
    samples = torch.empty((n_steps, b, h, w), dtype=torch.int32, device=state.device)
    nflips = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    for k in range(n_steps):
        u_k = fused_uniforms(k0b, k1b, t0b, k, (b, h, w), lat_b)
        nxt = _half_sweep(state, u_k, logit, checker == (t0 + k) % 2)
        nflips += (nxt != state).to(torch.int32)
        samples[k] = state = nxt
    return samples, nflips


def tie_events(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Indices where ``u`` lies within ``TIE_ULPS`` ULP of the flip
    probability ``p``: the only draws where two ``exp`` implementations
    (XLA's, PyTorch's, CUDA's ``expf``) may decide differently."""
    ulp = torch.nextafter(p, torch.full_like(p, float("inf"))) - p
    return torch.nonzero(torch.abs(u - p) <= TIE_ULPS * ulp)


def chain_ties(init, u, logit, parity0=0) -> torch.Tensor:
    """The tie events of the chain ``gibbs_chain_ref`` runs, on the active
    sites of each half-sweep: (k, b, h, w) indices."""
    samples, _ = gibbs_chain_ref(init, u, logit, parity0)
    prev = torch.cat([init.to(samples.dtype)[None], samples[:-1]])
    b, h, w = init.shape
    ks = torch.arange(u.shape[0], device=u.device).reshape(-1, 1, 1, 1)
    par0 = _per_lattice(parity0, b, u.device)
    active = checkerboard(h, w, u.device) == (par0 + ks) % 2
    p = sigmoid(logit(prev))
    ties = tie_events(u, p)
    keep = active[tuple(ties.t())]
    return ties[keep]
