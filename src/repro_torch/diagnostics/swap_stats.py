"""Replica-exchange diagnostics — streaming swap statistics (a copy of
``repro.diagnostics.swap_stats``, numpy only).

A tempering driver feeds one ``record`` per swap
event; state is O(num_replicas · num_elements) regardless of chain
length, mirroring ``StreamingChainStats``' streaming contract:

  * **per-pair swap acceptance** — attempt/accept counts per adjacent
    pair (r, r+1), pooled over elements and events.  Healthy ladders
    show rates in roughly (0.2, 0.6); a ~0 pair is a bottleneck that
    splits the ladder, a ~1 pair is wasted replicas.
  * **round trips** — walker labels ride the replica slots and move
    with accepted swaps; a round trip is cold → hot → cold, the
    standard measure of how well the ladder actually transports
    configurations across temperatures (swap rates alone can look
    healthy while walkers diffuse nowhere).

Updates are host-side numpy, off the sampling hot path like the chain
estimators.
"""

from __future__ import annotations

import numpy as np


class SwapStats:
    """Accumulate per-pair acceptance and walker round trips from
    per-swap-event ``record`` calls."""

    def __init__(self, num_replicas: int, elem_shape: tuple = ()):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}"
            )
        self.num_replicas = num_replicas
        self.elem_shape = tuple(elem_shape)
        self.num_elements = int(np.prod(self.elem_shape, dtype=np.int64))
        n_pairs = num_replicas - 1
        self.attempts = np.zeros(n_pairs, np.int64)
        self.accepts = np.zeros(n_pairs, np.int64)
        self.events = 0
        self.round_trips = 0
        e = self.num_elements
        # walker id currently at slot r, per element — starts as identity
        self._walker = np.tile(
            np.arange(num_replicas, dtype=np.int32)[:, None], (1, e)
        )
        # phase of the walker at slot r: -1 never cold yet, 0 last
        # touched cold (slot 0), 1 cold-then-hot (slot R-1)
        self._phase = np.full((num_replicas, e), -1, np.int8)
        self._phase[0] = 0

    def record(self, attempted, accepted) -> "SwapStats":
        """Consume one swap event: ``attempted`` (R-1,) bool marks the
        active-parity pairs, ``accepted`` (R-1, *elem) bool the
        per-element accepted exchanges (False wherever not attempted)."""
        n_pairs = self.num_replicas - 1
        attempted = np.asarray(attempted, bool).reshape(n_pairs)
        accepted = np.asarray(accepted, bool).reshape(
            n_pairs, self.num_elements
        )
        accepted = accepted & attempted[:, None]
        self.attempts += attempted * self.num_elements
        self.accepts += accepted.sum(axis=1)
        self.events += 1
        # move walker labels (and their phases) along accepted swaps;
        # active-parity pairs are disjoint so sequential apply is exact
        for i in np.nonzero(attempted)[0]:
            m = accepted[i]
            for arr in (self._walker, self._phase):
                lo, hi = arr[i].copy(), arr[i + 1].copy()
                arr[i] = np.where(m, hi, lo)
                arr[i + 1] = np.where(m, lo, hi)
        # round-trip bookkeeping after the move: a cold-slot walker that
        # had reached the hot end completes cold -> hot -> cold
        cold = self._phase[0]
        self.round_trips += int((cold == 1).sum())
        self._phase[0] = 0
        hot = self._phase[-1]
        self._phase[-1] = np.where(hot == 0, np.int8(1), hot)
        return self

    def pair_accept_rates(self) -> list[float]:
        """Acceptance fraction per adjacent pair (NaN if never tried)."""
        with np.errstate(invalid="ignore"):
            rates = self.accepts / np.where(self.attempts > 0,
                                            self.attempts, 1)
        return [
            float(r) if a > 0 else float("nan")
            for r, a in zip(rates, self.attempts)
        ]

    def summary(self) -> dict:
        """The swap bundle merged into CLI/bench rows."""
        total_att = int(self.attempts.sum())
        out = {
            "swap_events": int(self.events),
            "swap_accept_rate": round(
                float(self.accepts.sum()) / total_att, 4
            ) if total_att else float("nan"),
            "pair_accept_rate": [
                round(r, 4) if r == r else r
                for r in self.pair_accept_rates()
            ],
            "round_trips": int(self.round_trips),
        }
        return out
