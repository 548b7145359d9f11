"""Straggler detection for 1000+ node fleets.

The port's own copy of ``repro.distributed.straggler`` (the host-only
module imports nothing of either package).

Per-host step wall-times feed an EMA; hosts whose smoothed step time
exceeds ``threshold`` x the fleet median are flagged.  The *policy* applied
to a flagged host (re-slice its data shard away, drain + hot-swap, or just
alert) is deployment-specific; this module implements the detector plus a
pluggable policy callback, and the launcher wires it to logging in this
container (no real fleet to evict from).

The detector is deliberately stateless across restarts (a restarted host
re-earns its reputation) and robust to fleet-wide slowdowns (median-relative,
so a global slow step flags nobody).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable


@dataclasses.dataclass
class HostStats:
    ema_s: float | None = None
    flagged: bool = False
    n_steps: int = 0


class StragglerWatchdog:
    def __init__(
        self,
        n_hosts: int,
        threshold: float = 1.5,
        ema_alpha: float = 0.3,
        min_steps: int = 5,
        on_flag: Callable[[int, float, float], None] | None = None,
    ):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.min_steps = min_steps
        self.hosts = {h: HostStats() for h in range(n_hosts)}
        self.on_flag = on_flag or (lambda *a: None)

    def record(self, host_id: int, step_time_s: float):
        st = self.hosts[host_id]
        st.n_steps += 1
        st.ema_s = (
            step_time_s
            if st.ema_s is None
            else self.alpha * step_time_s + (1 - self.alpha) * st.ema_s
        )

    def check(self) -> list[int]:
        """Returns newly-flagged host ids (and fires the policy callback)."""
        emas = [s.ema_s for s in self.hosts.values() if s.ema_s is not None]
        ready = [s for s in self.hosts.values() if s.n_steps >= self.min_steps]
        if len(ready) < max(2, len(self.hosts) // 2) or not emas:
            return []
        med = statistics.median(emas)
        newly = []
        for hid, st in self.hosts.items():
            if st.ema_s is None or st.n_steps < self.min_steps:
                continue
            is_slow = st.ema_s > self.threshold * med
            if is_slow and not st.flagged:
                st.flagged = True
                newly.append(hid)
                self.on_flag(hid, st.ema_s, med)
            elif not is_slow and st.flagged:
                st.flagged = False  # recovered
        return newly

    @property
    def flagged(self) -> list[int]:
        return [h for h, s in self.hosts.items() if s.flagged]
