"""The workloads of the PyTorch port — the counterpart of
``repro.workloads``.

Every workload is a target, an engine configuration and a scalar
statistic of the sample stream that ``repro_torch.diagnostics`` judges.
``build(name, key, ...)`` assembles a ``WorkloadRun``; ``run(key)`` goes
through ``engine.submit(RunPlan)``.  The registry holds ``gmm`` (MH over
a Gaussian-mixture table), ``ising`` and ``spin_glass`` (checkerboard
Gibbs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch import diagnostics, samplers
from repro_torch.workloads import gmm, ising, spin_glass


@dataclasses.dataclass
class WorkloadRun:
    """One assembled workload: engine + target + chain layout + statistic."""

    name: str
    engine: samplers.MHEngine
    target: object
    init_words: object
    n_steps: int
    burn_in: int
    series_fn: Callable          # samples (K, *chain) -> (K, n_chains) stat
    meta: dict

    def plan(self, key, mesh=None, **overrides) -> samplers.RunPlan:
        """The workload's ``RunPlan``, the spec ``run`` submits."""
        spec = dict(
            target=self.target, n_steps=self.n_steps, init_words=self.init_words,
            key=key, mesh=mesh,
        )
        spec.update(overrides)
        return samplers.RunPlan(**spec)

    def run(self, key, mesh=None) -> samplers.EngineResult:
        """Run the chains; ``mesh`` (a 1-D ``DeviceMesh``) shards a
        multi-chain run's chain axis across its ranks."""
        return self.engine.submit(self.plan(key, mesh=mesh)).result

    def series(self, result: samplers.EngineResult) -> np.ndarray:
        """(T, n_columns) block of the scalar statistic; a multi-chain
        run's chains contribute their columns side by side."""
        num_chains = self.engine.config.num_chains
        if num_chains == 1:
            series = self.series_fn(result.samples).cpu().numpy()
            return series.reshape(series.shape[0], -1)
        cols = [
            self.series_fn(result.samples[c]).cpu().numpy().reshape(
                result.samples.shape[1], -1
            )
            for c in range(num_chains)
        ]
        return np.concatenate(cols, axis=1)

    @property
    def rate_key(self) -> str:
        """The label of the engine's accept/flip rate: Gibbs has no
        reject, so its count is a flip count — ``flip_rate`` for gibbs,
        ``acceptance_rate`` for mh."""
        return (
            "flip_rate" if self.engine.config.update == "gibbs" else "acceptance_rate"
        )

    def rate_entry(self, result: samplers.EngineResult) -> tuple[str, float]:
        """(label, value) of the engine's accept/flip rate."""
        return self.rate_key, round(float(result.acceptance_rate), 4)

    def kept_burn_in(self) -> int:
        """``burn_in`` as a row index of the collected stream: under
        ``thin:k`` the kept steps are t = 0, k, 2k, ..., so ceil(burn_in
        / k) kept rows fall inside the burn-in window."""
        mode, k = samplers.parse_collect(self.engine.config.collect)
        if mode == "thin":
            return -(-self.burn_in // k)
        return self.burn_in

    def diagnostics(self, result: samplers.EngineResult) -> dict:
        """Chain diagnostics over the post-burn-in scalar statistic, as
        the JAX package computes them: single-chain runs through
        ``diagnostics.summarize``, multi-chain runs through the streaming
        estimators in ``chunk_steps`` chunks; under ``last`` only the rate
        is reported."""
        mode, _ = samplers.parse_collect(self.engine.config.collect)
        label, value = self.rate_entry(result)
        if mode == "last":
            return {"n_steps": 0, label: value}
        series = self.series(result)[self.kept_burn_in():]
        rate = float(result.acceptance_rate)
        if self.engine.config.num_chains == 1:
            out = diagnostics.summarize(series, acceptance_rate=rate)
        else:
            chunk = max(1, self.engine.config.chunk_steps)
            out = diagnostics.summarize_stream(
                (series[s:s + chunk] for s in range(0, series.shape[0], chunk)),
                num_chains=series.shape[1],
                total_steps=series.shape[0],
                acceptance_rate=rate,
            )
        if label != "acceptance_rate":
            out[label] = out.pop("acceptance_rate")
        return out


WORKLOADS = {
    "gmm": gmm.build,
    "ising": ising.build,
    "spin_glass": spin_glass.build,
}


def build(name: str, key, **kwargs) -> WorkloadRun:
    """Assemble a registered workload by name."""
    try:
        builder = WORKLOADS[name]
    except KeyError:
        raise ValueError(f"unknown workload {name!r} (have {sorted(WORKLOADS)})") from None
    return builder(key, **kwargs)
