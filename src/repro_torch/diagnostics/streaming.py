"""Streaming chain diagnostics — O(chunk) memory over (C, T) sample blocks.

A copy of ``repro.diagnostics.streaming`` (numpy only): the PyTorch port
keeps its own copy rather than import the JAX package.  Keep the two
identical.

The multi-chain engine (DESIGN.md §Chains-axis) produces a (C, T) block
of a scalar statistic per run; for long chains the diagnostics must not
re-materialise the whole block.  ``StreamingChainStats`` consumes the
series in chunks of any size and reproduces the batch estimators of
``chain_stats`` from O(num_chains * max_lag) state:

  * **tau / ESS** — the windowed Sokal estimator needs the autocovariance
    at lags 0..M where M is the (data-dependent) Sokal window.  Streaming
    state per chain: running sum, lag-k cross-product sums for
    k <= max_lag (a ring buffer of the last ``max_lag`` values produces
    each new product), plus the first/last ``max_lag`` values for the
    end-correction — acov_k = S_k - mean*(A_k + B_k) + (n-k)*mean^2.
    Exact w.r.t. the batch estimator whenever the Sokal window lands
    inside ``max_lag`` (asserted in tests); a window hitting the cap is
    reported via ``window_capped``.
  * **split-R-hat** — total steps are known up front (the engine knows
    ``n_steps``), so each arriving value routes to its half-sequence by
    absolute index; per half-sequence running (count, sum, sum-of-squares)
    reproduce BDA3 split-R-hat exactly.

Layout convention matches ``chain_stats``: chunks are (t, n_chains)
float blocks of a scalar statistic per step, concatenated over t.
"""

from __future__ import annotations

import numpy as np


class StreamingChainStats:
    """Accumulate chain diagnostics from (t, n_chains) chunks.

    Feed chunks with :meth:`update` (total rows must reach
    ``total_steps``), then read :meth:`summarize` — a dict with the same
    keys (and, within the max-lag window, the same values) as
    ``chain_stats.summarize`` over the concatenated series.
    """

    def __init__(
        self,
        num_chains: int,
        total_steps: int,
        max_lag: int | None = None,
        c: float = 5.0,
    ):
        if num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {num_chains}")
        if total_steps < 2:
            raise ValueError(f"need at least 2 steps, got {total_steps}")
        self.num_chains = num_chains
        self.total_steps = total_steps
        self.max_lag = min(
            total_steps - 1, 256 if max_lag is None else max_lag
        )
        if self.max_lag < 1:
            raise ValueError(f"max_lag must be >= 1, got {self.max_lag}")
        self.c = c
        self.n = 0
        cshape = (num_chains,)
        self._sum = np.zeros(cshape)
        # lag-k cross-product sums S_k = sum_t x_t * x_{t+k}, k = 0..max_lag
        self._cross = np.zeros((self.max_lag + 1, num_chains))
        self._head = np.empty((0, num_chains))  # first max_lag values
        self._tail = np.empty((0, num_chains))  # last max_lag values
        # half-sequence accumulators for split-R-hat: (2, C) each
        self._half_n = np.zeros((2, num_chains))
        self._half_sum = np.zeros((2, num_chains))
        self._half_sumsq = np.zeros((2, num_chains))

    def update(self, block) -> "StreamingChainStats":
        """Consume the next (t, n_chains) rows of the series."""
        block = _as_chains_chunk(block, self.num_chains)
        t = block.shape[0]
        if self.n + t > self.total_steps:
            raise ValueError(
                f"stream overflow: got {self.n + t} rows, declared "
                f"total_steps={self.total_steps}"
            )
        lag = self.max_lag
        ext = np.concatenate([self._tail, block], axis=0)
        off = self._tail.shape[0]
        for k in range(min(lag, self.n + t - 1) + 1):
            lo = max(0, k - self.n)  # first new row with a lag-k partner
            if lo < t:
                self._cross[k] += np.sum(
                    ext[off + lo - k : off + t - k] * block[lo:], axis=0
                )
        self._sum += block.sum(axis=0)
        if self._head.shape[0] < lag:
            self._head = np.concatenate([self._head, block])[:lag]
        self._tail = ext[-lag:] if ext.shape[0] >= lag else ext
        # split-R-hat half routing by absolute index
        half_len = self.total_steps // 2
        idx = self.n + np.arange(t)
        for h in (0, 1):
            sel = (idx >= h * half_len) & (idx < (h + 1) * half_len)
            if sel.any():
                rows = block[sel]
                self._half_n[h] += rows.shape[0]
                self._half_sum[h] += rows.sum(axis=0)
                self._half_sumsq[h] += (rows * rows).sum(axis=0)
        self.n += t
        return self

    # --- cross-shard merge ---------------------------------------------

    def merge(self, other: "StreamingChainStats") -> "StreamingChainStats":
        """Combine with an accumulator over a *disjoint* chain shard.

        The engine's "chains" sharding rule never communicates between
        chains (DESIGN.md §Chains-axis), so each shard can stream its
        own (t, C/n_shards) blocks locally; merging is exact — every
        per-chain field simply concatenates along the chain axis, and
        the chain-averaged estimators (tau, split-R-hat) computed from
        the merged state equal the unsharded accumulator's bit-for-bit.
        Both sides must cover the same step span (same ``total_steps``,
        ``max_lag``, ``c``, and rows consumed so far).
        """
        for attr in ("total_steps", "max_lag", "c", "n"):
            if getattr(self, attr) != getattr(other, attr):
                raise ValueError(
                    f"cannot merge shards that disagree on {attr}: "
                    f"{getattr(self, attr)} != {getattr(other, attr)} — "
                    "shards must stream the same step span in lock-step"
                )
        out = StreamingChainStats(
            self.num_chains + other.num_chains,
            self.total_steps,
            max_lag=self.max_lag,
            c=self.c,
        )
        out.n = self.n
        cat = lambda a, b: np.concatenate([a, b], axis=-1)  # noqa: E731
        out._sum = cat(self._sum, other._sum)
        out._cross = cat(self._cross, other._cross)
        out._head = cat(self._head, other._head)
        out._tail = cat(self._tail, other._tail)
        out._half_n = cat(self._half_n, other._half_n)
        out._half_sum = cat(self._half_sum, other._half_sum)
        out._half_sumsq = cat(self._half_sumsq, other._half_sumsq)
        return out

    @classmethod
    def merge_shards(cls, shards) -> "StreamingChainStats":
        """Fold an iterable of per-shard accumulators (chain order =
        shard order, matching the mesh's device order)."""
        shards = list(shards)
        if not shards:
            raise ValueError("merge_shards needs at least one accumulator")
        out = shards[0]
        for s in shards[1:]:
            out = out.merge(s)
        return out

    # --- estimators ----------------------------------------------------

    def _autocov(self) -> np.ndarray:
        """(max_lag+1, C) end-corrected autocovariance sums (not /n),
        matching chain_stats.autocorrelation's FFT linear autocovariance."""
        n = self.n
        lag = min(self.max_lag, n - 1)
        mean = self._sum / n
        acov = np.empty((lag + 1, self.num_chains))
        for k in range(lag + 1):
            a_k = self._sum - (self._tail[-k:].sum(axis=0) if k else 0.0)
            b_k = self._sum - (self._head[:k].sum(axis=0) if k else 0.0)
            acov[k] = self._cross[k] - mean * (a_k + b_k) + (n - k) * mean**2
        return acov

    def tau(self) -> tuple[float, bool]:
        """(Sokal tau averaged over chains, window-hit-the-cap flag)."""
        if self.n < 2:
            raise ValueError(f"need at least 2 steps, got {self.n}")
        acov = self._autocov()
        var0 = acov[0]
        rho = np.where(var0 > 0.0, acov / np.where(var0 > 0.0, var0, 1.0), 1.0)
        rho_mean = rho.mean(axis=1)
        taus = 2.0 * np.cumsum(rho_mean) - 1.0
        window = np.arange(taus.size) < self.c * taus
        capped = bool(window.all()) and taus.size < self.n
        m = taus.size - 1 if window.all() else int(np.argmin(window))
        return float(np.clip(taus[m], 1.0, self.n)), capped

    def split_rhat(self) -> float:
        nh = self.total_steps // 2
        if nh < 2:
            raise ValueError(
                f"split_rhat needs at least 4 steps, got {self.total_steps}"
            )
        if not np.all(self._half_n == nh):
            raise ValueError(
                f"stream incomplete: halves hold {self._half_n.min()} of "
                f"{nh} rows"
            )
        means = (self._half_sum / nh).reshape(-1)        # (2C,)
        sq = (self._half_sumsq / nh).reshape(-1)
        variances = (sq - means**2) * nh / (nh - 1)      # ddof=1
        within = float(np.mean(variances))
        between = nh * float(np.var(means, ddof=1))
        if within <= 0.0:
            return 1.0 if between <= 0.0 else float(np.inf)
        var_plus = (nh - 1) / nh * within + between / nh
        return float(np.sqrt(var_plus / within))

    def summarize(self, acceptance_rate: float | None = None) -> dict:
        """The chain_stats.summarize bundle, computed from streamed state."""
        if self.n != self.total_steps:
            raise ValueError(
                f"stream incomplete: {self.n} of {self.total_steps} rows"
            )
        tau, capped = self.tau()
        size = self.n * self.num_chains
        mean = float(self._sum.mean() / self.n)
        sq = float(self._cross[0].sum() / size)
        out = {
            "n_steps": int(self.n),
            "n_chains": int(self.num_chains),
            "tau": round(tau, 3),
            "ess": round(size / tau, 1),
            "ess_per_step": round(size / tau / self.n, 4),
            "split_rhat": round(self.split_rhat(), 4),
            "mean": round(mean, 5),
            "std": round(float(np.sqrt(max(sq - mean**2, 0.0))), 5),
        }
        if capped:
            out["window_capped"] = True
        if acceptance_rate is not None:
            out["acceptance_rate"] = round(float(acceptance_rate), 4)
        return out


def _as_chains_chunk(x, num_chains: int) -> np.ndarray:
    """Coerce one chunk to (t, num_chains) float64 (t >= 1 is enough —
    chunk boundaries need not satisfy the >= 2 rule of _as_chains)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[1] != num_chains:
        raise ValueError(
            f"chunk must be (t, {num_chains}), got {x.shape}"
        )
    return x


def summarize_stream(
    chunks,
    num_chains: int,
    total_steps: int,
    max_lag: int | None = None,
    acceptance_rate: float | None = None,
    c: float = 5.0,
) -> dict:
    """One-call streaming bundle over an iterable of (t, C) chunks."""
    acc = StreamingChainStats(num_chains, total_steps, max_lag=max_lag, c=c)
    for chunk in chunks:
        acc.update(chunk)
    return acc.summarize(acceptance_rate=acceptance_rate)
