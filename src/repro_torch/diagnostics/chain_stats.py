"""MCMC chain diagnostics — is the macro's sample stream actually good?

A copy of ``repro.diagnostics.chain_stats`` (numpy only): the PyTorch port
keeps its own copy rather than import the JAX package.  Keep the two
identical.

Host-side (numpy, float64) estimators over engine outputs; none of this
is on the sampling hot path, so clarity beats jit-ability:

  * ``integrated_autocorr_time`` — Sokal's windowed estimator of the
    integrated autocorrelation time tau, with the automatic window
    M = min{m : m >= c * tau(m)} (c = 5, the emcee default).  FFT-based
    autocovariance, averaged across chains.
  * ``effective_sample_size``    — ESS = N_total / tau.  An i.i.d. chain
    has tau ~ 1 => ESS ~ N; a sticky chain has tau >> 1 => ESS << N.
  * ``split_rhat``               — Gelman–Rubin potential scale reduction
    with each chain split in half (BDA3 §11.4), which also flags
    within-chain non-stationarity.  ~1 at convergence; > ~1.1 is the
    conventional "keep sampling" threshold.

Conventions: chains are arrays shaped (n_steps,) or (n_steps, n_chains)
of a *scalar* statistic per step (decoded coordinate, magnetisation, …).
Degenerate inputs are defined rather than NaN: a zero-variance chain set
gets tau = n_steps (ESS = n_chains), and split-R-hat of a zero-variance
set is 1.0 (identical constants are trivially converged).
"""

from __future__ import annotations

import numpy as np


def _as_chains(x) -> np.ndarray:
    """Coerce to (n_steps, n_chains) float64."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(
            f"chains must be (n_steps,) or (n_steps, n_chains), got {x.shape}"
        )
    if x.shape[0] < 2:
        raise ValueError(f"need at least 2 steps, got {x.shape[0]}")
    return x


def autocorrelation(chain: np.ndarray) -> np.ndarray:
    """Normalised autocorrelation function of one 1-D chain (FFT-based)."""
    x = np.asarray(chain, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError(f"autocorrelation takes a 1-D chain, got {x.shape}")
    n = x.size
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n]
    if acov[0] <= 0.0:
        # zero-variance chain: perfectly correlated by convention
        return np.ones(n)
    return acov / acov[0]


def integrated_autocorr_time(chains, c: float = 5.0) -> float:
    """Sokal-windowed integrated autocorrelation time, averaged over chains.

    tau(m) = 1 + 2 * sum_{t<=m} rho(t); the window is the smallest m with
    m >= c * tau(m).  Clipped to [1, n_steps].
    """
    x = _as_chains(chains)
    n = x.shape[0]
    rho = np.mean([autocorrelation(x[:, j]) for j in range(x.shape[1])], axis=0)
    taus = 2.0 * np.cumsum(rho) - 1.0  # rho[0] == 1 contributes once
    window = np.arange(n) < c * taus
    m = int(np.argmin(window)) if not window.all() else n - 1
    return float(np.clip(taus[m], 1.0, n))


def effective_sample_size(chains, c: float = 5.0) -> float:
    """ESS = (n_steps * n_chains) / tau."""
    x = _as_chains(chains)
    return float(x.size / integrated_autocorr_time(x, c=c))


def split_rhat(chains) -> float:
    """Split-chain Gelman–Rubin R-hat (BDA3 §11.4).

    Each chain is split into halves (2 * n_chains sequences of n // 2
    steps); R-hat = sqrt(((n-1)/n * W + B/n) / W) with W the mean
    within-sequence variance and B the between-sequence variance.
    """
    x = _as_chains(chains)
    n = (x.shape[0] // 2) * 2
    if n < 4:
        raise ValueError(f"split_rhat needs at least 4 steps, got {x.shape[0]}")
    halves = x[:n].T.reshape(-1, n // 2).T       # (n//2, 2 * n_chains)
    nh = halves.shape[0]
    within = np.mean(np.var(halves, axis=0, ddof=1))
    between = nh * np.var(np.mean(halves, axis=0), ddof=1)
    if within <= 0.0:
        return 1.0 if between <= 0.0 else np.inf
    var_plus = (nh - 1) / nh * within + between / nh
    return float(np.sqrt(var_plus / within))


def summarize(chains, acceptance_rate: float | None = None, c: float = 5.0) -> dict:
    """One-call diagnostic bundle over a scalar chain statistic."""
    x = _as_chains(chains)
    tau = integrated_autocorr_time(x, c=c)
    out = {
        "n_steps": int(x.shape[0]),
        "n_chains": int(x.shape[1]),
        "tau": round(tau, 3),
        "ess": round(x.size / tau, 1),
        "ess_per_step": round(x.size / tau / x.shape[0], 4),
        "split_rhat": round(split_rhat(x), 4),
        "mean": round(float(x.mean()), 5),
        "std": round(float(x.std()), 5),
    }
    if acceptance_rate is not None:
        out["acceptance_rate"] = round(float(acceptance_rate), 4)
    return out
