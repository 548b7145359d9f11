"""Plain PyTorch versions of the two MH chain kernels.

``mh_chain_ref`` is the counterpart of ``repro.kernels.mh.ref`` and the
plain version of ``csrc/mh.cu:mh_chain_kernel`` with ``OperandDraw``;
``mh_chain_fused_ref`` derives the fused kernel's operands through
``repro_torch.kernels.rng`` and runs the same chain, the plain version of
``mh_chain_kernel`` with ``FusedDraw``.
The CPU path of the wrappers and the card-side parity checks run these.

The accept test flushes ``exp`` results below 2^-126 to zero, as XLA does
on the CPU and TPU, so a rejection of a step with Δ below about -87.3
cannot depend on whether a denormal survived.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import rng

FLUSH = 2.0 ** -126  # least normal float32


def table_log_prob(table: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """``table[b, w]`` for words < V, else -inf: the lookup of every
    executor.  ``words`` is (..., B, C); leading axes share the table."""
    vocab = table.shape[-1]
    safe = torch.clamp(words, max=vocab - 1)
    vals = torch.gather(table.expand(*words.shape[:-1], vocab), -1, safe)
    return torch.where(words < vocab, vals, float("-inf"))


def accept_test(
    u: torch.Tensor, logp_cand: torch.Tensor, logp: torch.Tensor
) -> torch.Tensor:
    """``u < exp(min(Δ, 0))`` with denormal results flushed to 0, and a
    finite candidate log-prob: the one accept rule of every executor."""
    delta = logp_cand - logp
    e = torch.exp(torch.minimum(delta, torch.zeros_like(delta)))
    e = torch.where(e < FLUSH, torch.zeros_like(e), e)
    return (u < e) & torch.isfinite(logp_cand)


def mh_chain_ref(
    table: torch.Tensor,   # (B, V) float32 log-probs (unnormalised)
    init: torch.Tensor,    # (B, C) uint32 words (int64)
    flips: torch.Tensor,   # (K, B, C) uint32 flip words (int64)
    u: torch.Tensor,       # (K, B, C) float32 uniforms
    nbits: int,
):
    """K MH steps over (B targets x C chains).

    Returns (samples (K, B, C) uint32 words as int64, accept (B, C) int32).
    """
    mask = (1 << nbits) - 1
    state = init.to(torch.int64)
    logp = table_log_prob(table, state)
    acc = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    samples = torch.empty(flips.shape, dtype=torch.int64, device=state.device)
    for k in range(flips.shape[0]):
        cand = state ^ (flips[k] & mask)
        logp_cand = table_log_prob(table, cand)
        accept = accept_test(u[k], logp_cand, logp)
        state = torch.where(accept, cand, state)
        logp = torch.where(accept, logp_cand, logp)
        acc += accept.to(torch.int32)
        samples[k] = state
    return samples, acc


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at |x| (0 where x is not finite)."""
    a = torch.abs(x)
    gap = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return torch.where(torch.isfinite(x), gap, torch.zeros_like(gap))


def tie_events(table, init, flips, u, nbits: int, logp_ulps: int = 0) -> torch.Tensor:
    """Steps of the chain ``mh_chain_ref`` runs where the accept decision
    could depend on the last bit of ``exp``: a finite candidate whose
    ``u`` lies within one ULP of ``e = exp(min(Δ, 0))``, or ``u == 0``
    with ``e`` at the flush threshold.  Implementations of ``exp`` (XLA's,
    PyTorch's, CUDA's ``expf``) may differ by an ULP there, and nowhere
    else can two chains part.

    ``logp_ulps`` widens the window for a table known only to within that
    many ULP per entry (a density evaluated by two implementations): Δ
    may then move by that many ULP of each log-prob, and ``e`` with it.
    Returns the (k, b, c) indices."""
    samples, _ = mh_chain_ref(table, init, flips, u, nbits)
    prev = torch.cat([init.to(torch.int64)[None], samples[:-1]])
    logp = table_log_prob(table, prev)
    logp_cand = table_log_prob(table, prev ^ (flips & ((1 << nbits) - 1)))
    delta = logp_cand - logp
    e = torch.exp(torch.minimum(delta, torch.zeros_like(delta)))
    ulp = torch.nextafter(e, torch.full_like(e, float("inf"))) - e
    slack = logp_ulps * (_ulp(logp) + _ulp(logp_cand))
    window = ulp + e * torch.expm1(slack)
    near_flush = (u == 0) & (torch.abs(e - FLUSH) <= FLUSH * 2.0**-20)
    tie = torch.isfinite(logp_cand) & ((torch.abs(u - e) <= window) | near_flush)
    return torch.nonzero(tie)


def accept_margin(table, init, flips, u, nbits: int) -> float:
    """The least ``|log u - min(Δ, 0)|`` (float64) over the steps of the
    chain ``mh_chain_ref`` runs whose candidate has a finite log-prob and
    whose ``u`` is above 0: a second table within half of it of
    ``table``, entry by entry, takes every accept decision the same way
    (``inf`` when no step qualifies)."""
    samples, _ = mh_chain_ref(table, init, flips, u, nbits)
    prev = torch.cat([init.to(torch.int64)[None], samples[:-1]])
    logp = table_log_prob(table, prev).double()
    logp_cand = table_log_prob(table, prev ^ (flips & ((1 << nbits) - 1))).double()
    live = torch.isfinite(logp_cand) & (u > 0)
    gap = torch.abs(torch.log(u.double()) - torch.clamp(logp_cand - logp, max=0.0))
    return float(gap[live].min()) if bool(live.any()) else math.inf


def fused_operands(
    k0c: torch.Tensor, k1c: torch.Tensor, t0c: torch.Tensor, *,
    rows: int, nbits: int, n_steps: int, cc: int, p_u32: int,
):
    """The (K, B, C) flip words and uniforms the fused kernel draws
    in-kernel: step ``t0c[c] + k`` (mod 2^32) at site ``b * cc + c % cc``
    under column key ``(k0c[c], k1c[c])``."""
    c = k0c.shape[0]
    dev = k0c.device
    col = torch.arange(c, dtype=torch.int64, device=dev)
    site = torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * cc + col % cc
    ks = torch.arange(n_steps, dtype=torch.int64, device=dev)[:, None]
    s0, s1 = rng.step_key(k0c, k1c, rng.u32(t0c) + ks)  # (K, C)
    s0, s1 = s0[:, None, :], s1[:, None, :]
    return rng.flips_at(s0, s1, site, nbits, p_u32), rng.uniform_at(s0, s1, site)


def mh_chain_fused_ref(
    table, init, k0c, k1c, t0c, *, nbits: int, n_steps: int, cc: int, p_u32: int
):
    """The fused kernel's chain: ``mh_chain_ref`` on ``fused_operands``."""
    flips, u = fused_operands(
        k0c, k1c, t0c, rows=init.shape[0], nbits=nbits, n_steps=n_steps,
        cc=cc, p_u32=p_u32,
    )
    return mh_chain_ref(table, init, flips, u, nbits)
