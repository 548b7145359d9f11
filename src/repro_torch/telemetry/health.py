"""Sampler health monitoring — the port of ``repro.telemetry.health``.

A production sampler's failure modes are statistical, not crashes: an
acceptance rate that collapses when a proposal scale is wrong, chains
whose split-R-hat diverges because they never mixed, a tempering ladder
whose walkers stall at one temperature, a serving tier whose p99 quietly
blows its SLO.  ``HealthMonitor`` consumes the accumulators the repo
already maintains — ``WorkloadRun.diagnostics`` bundles
(``StreamingChainStats`` output), ``SwapStats``, the serving tier's
``latency_summary`` — between chunks / after runs, and turns threshold
breaches into *structured* alerts:

  * each alert is a ``HealthAlert`` (kind, severity, message, data) the
    caller can route;
  * each alert raises a ``SamplerHealthWarning`` through the stdlib
    ``warnings`` machinery (filterable, testable with ``pytest.warns``);
  * each alert is logged through the telemetry tracer (an instant event
    named ``health.<kind>`` when tracing is on) and counted in the
    metrics registry (``sampler_health_alerts_total`` by kind).

The monitor never touches device values — it reads host-side floats the
layers already computed, so health checking costs nothing on the
sampling path.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

from repro_torch.telemetry import metrics as _metrics
from repro_torch.telemetry import tracing as _tracing


class SamplerHealthWarning(UserWarning):
    """Category for sampler-health alerts (filter with the stdlib
    ``warnings`` machinery)."""


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Trigger levels; ``None`` disables the corresponding check."""

    # chain health
    min_acceptance: float | None = 0.01   # accept/flip-rate collapse
    max_acceptance: float | None = None   # e.g. 0.999: no-reject suspicion
    max_rhat: float | None = 1.2          # split-R-hat divergence
    # tempering health
    min_swap_rate: float | None = 0.02    # a ~0 pair splits the ladder
    stall_events: int = 8                 # swap events before walkers
    #                                       with zero round trips count
    #                                       as stalled
    # serving SLOs (None = not enforced)
    p99_latency_slo_s: float | None = None
    max_wait_slo_s: float | None = None

    def __post_init__(self):
        if self.stall_events < 1:
            raise ValueError(
                f"stall_events must be >= 1, got {self.stall_events}"
            )


@dataclasses.dataclass(frozen=True)
class HealthAlert:
    """One structured breach: machine-routable kind + evidence."""

    kind: str        # acceptance_collapse | rhat_divergence | ...
    severity: str    # "warn" | "critical"
    message: str
    data: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class HealthMonitor:
    """Threshold checks over the existing accumulators.

    Alerts accumulate on the monitor (``monitor.alerts``) so a serve
    loop can poll them between chunks; every ``check_*`` also returns
    just the alerts it raised.  ``warn=False`` suppresses the stdlib
    warning (the CLI prints alerts itself).
    """

    def __init__(
        self,
        thresholds: HealthThresholds = HealthThresholds(),
        *,
        warn: bool = True,
    ):
        self.thresholds = thresholds
        self.warn = warn
        self.alerts: list[HealthAlert] = []

    # -- emission -------------------------------------------------------
    def _emit(
        self, kind: str, message: str, data: dict, severity: str = "warn"
    ) -> HealthAlert:
        alert = HealthAlert(
            kind=kind, severity=severity, message=message, data=data
        )
        self.alerts.append(alert)
        _tracing.log(f"health.{kind}", severity=severity, **data)
        _metrics.counter(
            "sampler_health_alerts_total",
            "sampler health alerts by kind",
        ).inc(kind=kind)
        if self.warn:
            warnings.warn(
                SamplerHealthWarning(f"[{kind}] {message}"), stacklevel=3
            )
        return alert

    # -- chain health ---------------------------------------------------
    def check_acceptance(
        self, rate: float, *, label: str = "acceptance_rate", where: str = ""
    ) -> list[HealthAlert]:
        """Accept/flip-rate collapse (and optional saturation)."""
        t = self.thresholds
        rate = float(rate)
        out = []
        if t.min_acceptance is not None and rate < t.min_acceptance:
            out.append(
                self._emit(
                    "acceptance_collapse",
                    f"{label} {rate:.4g} < {t.min_acceptance:g}"
                    + (f" ({where})" if where else ""),
                    {"rate": rate, "label": label, "where": where,
                     "threshold": t.min_acceptance},
                    severity="critical",
                )
            )
        if t.max_acceptance is not None and rate > t.max_acceptance:
            out.append(
                self._emit(
                    "acceptance_saturated",
                    f"{label} {rate:.4g} > {t.max_acceptance:g}"
                    + (f" ({where})" if where else ""),
                    {"rate": rate, "label": label, "where": where,
                     "threshold": t.max_acceptance},
                )
            )
        return out

    def check_chain_stats(self, stats, *, where: str = "") -> list[HealthAlert]:
        """R-hat divergence from a ``StreamingChainStats`` accumulator or
        an already-summarised diagnostics dict (the
        ``WorkloadRun.diagnostics`` bundle)."""
        t = self.thresholds
        out = []
        if isinstance(stats, dict):
            rhat = stats.get("split_rhat")
        else:  # a StreamingChainStats (or anything quacking like one)
            rhat = stats.split_rhat()
        if rhat is None or t.max_rhat is None:
            return out
        rhat = float(rhat)
        if not math.isfinite(rhat) or rhat > t.max_rhat:
            out.append(
                self._emit(
                    "rhat_divergence",
                    f"split-R-hat {rhat:.4g} > {t.max_rhat:g}"
                    + (f" ({where})" if where else ""),
                    {"split_rhat": rhat, "where": where,
                     "threshold": t.max_rhat},
                )
            )
        return out

    # -- tempering health -----------------------------------------------
    def check_swap_stats(self, swap, *, where: str = "") -> list[HealthAlert]:
        """Ladder bottlenecks + stalled walkers from a ``SwapStats``."""
        t = self.thresholds
        out = []
        rates = swap.pair_accept_rates()
        if t.min_swap_rate is not None:
            for pair, rate in enumerate(rates):
                if rate == rate and rate < t.min_swap_rate:  # NaN = untried
                    out.append(
                        self._emit(
                            "swap_bottleneck",
                            f"pair ({pair},{pair + 1}) swap rate "
                            f"{rate:.4g} < {t.min_swap_rate:g} — the "
                            "ladder is split at this temperature"
                            + (f" ({where})" if where else ""),
                            {"pair": pair, "rate": float(rate),
                             "where": where,
                             "threshold": t.min_swap_rate},
                        )
                    )
        if swap.events >= t.stall_events and swap.round_trips == 0:
            out.append(
                self._emit(
                    "stalled_walkers",
                    f"0 round trips after {swap.events} swap events — "
                    "walkers are not traversing the ladder"
                    + (f" ({where})" if where else ""),
                    {"events": int(swap.events), "round_trips": 0,
                     "where": where, "threshold": t.stall_events},
                )
            )
        return out

    # -- serving health --------------------------------------------------
    def check_serving(self, summary: dict, *, where: str = "") -> list[HealthAlert]:
        """SLO breaches from a ``latency_summary`` row."""
        t = self.thresholds
        out = []
        p99 = summary.get("p99_latency_s")
        if (
            t.p99_latency_slo_s is not None
            and p99 is not None
            and float(p99) > t.p99_latency_slo_s
        ):
            out.append(
                self._emit(
                    "latency_slo_breach",
                    f"p99 latency {float(p99):.4g}s > SLO "
                    f"{t.p99_latency_slo_s:g}s"
                    + (f" ({where})" if where else ""),
                    {"p99_latency_s": float(p99), "where": where,
                     "threshold": t.p99_latency_slo_s},
                    severity="critical",
                )
            )
        wait = summary.get("p99_wait_s", summary.get("mean_wait_s"))
        if (
            t.max_wait_slo_s is not None
            and wait is not None
            and float(wait) > t.max_wait_slo_s
        ):
            out.append(
                self._emit(
                    "wait_slo_breach",
                    f"queue wait {float(wait):.4g}s > SLO "
                    f"{t.max_wait_slo_s:g}s"
                    + (f" ({where})" if where else ""),
                    {"wait_s": float(wait), "where": where,
                     "threshold": t.max_wait_slo_s},
                )
            )
        return out
