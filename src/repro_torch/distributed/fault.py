"""Preemption / fault handling for long-running training.

The port's own copy of ``repro.distributed.fault`` (the host-only
module imports nothing of either package).

``PreemptionHandler`` converts SIGTERM/SIGINT into a *checkpoint request*
honoured at the next step boundary (never mid-step, so the saved state is
bit-exact a step boundary), after which the loop exits cleanly with code 0
— the contract cluster schedulers (Borg/K8s eviction, TPU maintenance
events) expect.  Training resumes from the latest checkpoint via
``CheckpointManager.restore_latest`` — combined with the (seed, step)-pure
data pipeline, the restarted run replays identical batches.

``simulate_preemption()`` triggers the same path in-process for the fault
injection test.
"""

from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        self._requested.set()

    def simulate_preemption(self):
        self._requested.set()

    @property
    def preemption_requested(self) -> bool:
        return self._requested.is_set()

    def clear(self):
        self._requested.clear()
