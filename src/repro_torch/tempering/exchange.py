"""Replica exchange (parallel tempering) over the engine's chain-id axis
— the PyTorch port of ``repro.tempering.exchange``.

R replicas sample p^beta_r through the engine; every ``swap_every``
steps adjacent pairs propose to exchange configurations with the
standard PT accept test

    u < exp(min((beta_r - beta_{r+1}) · (f(x_{r+1}) - f(x_r)), 0)),

f the beta = 1 log-prob per independent chain element — the MH step's
accept expression (``kernels/mh/ref.py:accept_test``: ``exp`` results
below 2^-126 flushed to 0, and a NaN delta never swaps).  Even/odd
adjacent pairs alternate between swap events.

Determinism contract (the JAX package's):

  * replica r's sampling stream is chain slot ``chain_id + r``;
  * segments between swap points run with ``step0 = <absolute step>``,
    so the concatenated per-replica stream is one unsegmented run's, and
    a 1-replica ladder is a plain run;
  * swap decisions key on the absolute step: the pair parity is
    ``(step // swap_every - 1) % 2`` and the swap uniforms come from the
    run's own ``RandomnessBackend`` at that step under the chain slot
    ``SWAP_STREAM_ID``.

Every segment goes through ``engine.submit(RunPlan)``; under ``pallas``
the Gibbs replicas reach ``csrc/gibbs.cu`` with their scaled logit spec
and the table replicas ``csrc/mh.cu`` with their scaled table.  When
every replica resolves to scan and the engine does not thin, a segment
runs through a compiled program (``_scan_segment``, JAX's jitted
segment with a traced ``step0``): one for each replica and segment
length, its ``step0`` a 0-d tensor staged from the host's step, so on
the card every segment of a replica is one graph replay.  The programs
live on the ``ReplicaExchange`` for the targets of its last run (a run
on other targets frees them first) and share one memory pool, since a
run replays them one at a time.  The swap
sweep runs on the engine's device and reads nothing back: its accept
masks are copied to the host once, at the end of the run, for
``SwapStats``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import compiled, telemetry
from repro_torch.diagnostics import SwapStats
from repro_torch.kernels.mh.ref import FLUSH
from repro_torch.samplers import MHEngine, RunPlan, chain_key
from repro_torch.samplers.engine import _acceptance_rate, parse_collect, resolve_execution
from repro_torch.tempering.ladder import base_log_prob

# chain-id slot of the swap-uniform stream: spells "SWAP", far outside
# any plausible replica range so it never collides with chain_key(·, r)
SWAP_STREAM_ID = 0x53574150


@dataclasses.dataclass
class TemperedResult:
    """One replica-exchange run.  Slot-major layout: index r of every
    field is the replica *slot* holding beta_r throughout the run (swaps
    exchange configurations between slots, never the betas).  Words are
    uint32 values in int64 tensors, as everywhere in the port."""

    samples: torch.Tensor          # (R, n_kept, *chain_shape)
    accept_count: torch.Tensor     # (R, *chain_shape) int32 within-replica moves
    acceptance_rate: torch.Tensor  # scalar float32, pooled over replicas
    final_words: torch.Tensor      # (R, *chain_shape)
    final_logp: torch.Tensor       # (R, *elem) float32 beta=1 log-prob
    swap: SwapStats
    n_steps: int
    betas: tuple[float, ...]

    @property
    def cold_samples(self) -> torch.Tensor:
        """The beta = betas[0] (target-measure) sample stream."""
        return self.samples[0]


def swap_accept(delta: torch.Tensor, u: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The swap test of each pair and element: ``active`` (R-1, 1, ...)
    pairs with ``u < exp(min(delta, 0))``, ``exp`` below 2^-126 flushed to
    0 (XLA's denormal flush); a NaN delta (two -inf states) never swaps."""
    e = torch.exp(torch.minimum(delta, torch.zeros_like(delta)))
    e = torch.where(e < FLUSH, torch.zeros_like(e), e)
    return active & (u < e)


def _segment_body(engine, target, n_steps, chain_id, key, init, step0):
    """One replica segment through the run surface, as every call site
    launches one."""
    plan = RunPlan(target=target, n_steps=n_steps, init_words=init, key=key,
                   chain_id=chain_id, step0=step0)
    return engine.submit(plan).result


def _scan_segment(programs: dict, engine, target, n_steps: int, chain_id: int, key, init,
                  step: int):
    """One replica segment under scan execution through a compiled program
    in ``programs``: JAX's jitted ``_scan_segment``, whose statics are the
    engine and target (by identity), ``n_steps`` and ``chain_id``, and
    whose ``step0`` is traced.  The key, the init words and ``step0`` (a
    0-d int64 tensor the host fills from ``step``) are staged, so every
    segment of a replica shares one program.  A program holds its target;
    the programs of one dict share a memory pool."""
    step0 = torch.full((), int(step), dtype=torch.int64)
    inputs = (key, init, step0)
    sig = (id(target), int(n_steps), int(chain_id), *(compiled.layout(x) for x in inputs))
    result, _ = compiled.call(
        programs, sig,
        functools.partial(_segment_body, engine, target, int(n_steps), int(chain_id)),
        inputs, engine.device, f"tempering scan segment {sig}", holds=target,
        name="the scan segment", share_pool=True,
    )
    return result


@dataclasses.dataclass(frozen=True)
class ReplicaExchange:
    """Parallel-tempering driver: ``ladder`` replicas of ``engine``'s
    update rule with even/odd adjacent swaps every ``swap_every`` steps."""

    ladder: object
    engine: MHEngine
    swap_every: int = 16
    # the scan segment programs (``_scan_segment``) of the last run's
    # targets, by signature
    _programs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        if self.swap_every < 1:
            raise ValueError(f"swap_every must be >= 1, got {self.swap_every}")
        if self.engine.config.num_chains != 1:
            raise ValueError(
                "replica exchange occupies the chain-id axis (replica r = "
                "chain slot chain_id + r); run independent tempered "
                "ensembles by batching the target/init instead of "
                f"num_chains={self.engine.config.num_chains}"
            )

    def run(
        self, key, target, n_steps: int, init_words, *, chain_id: int = 0, _observe=None,
    ) -> TemperedResult:
        """Run ``n_steps`` per replica from ``init_words`` (leading
        (num_replicas,) axis, required explicitly like the engine's chains
        axis) and swap at every interior multiple of ``swap_every``.
        ``_observe`` (``tie_events``) sees each segment's plan and each
        sweep's (delta, u, active)."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        num_replicas = self.ladder.num_replicas
        engine = self.engine
        init = engine._words(init_words)
        if init.ndim == 0 or init.shape[0] != num_replicas:
            raise ValueError(
                f"tempered init_words must carry a leading "
                f"(num_replicas={num_replicas},) axis, got {tuple(init.shape)}; "
                f"broadcast a shared init with init.expand({num_replicas}, *init.shape)"
            )
        key = engine._key(key)
        targets = self.ladder.targets(target)
        # refuse an executor a replica cannot run, before any segment
        scan_exec = all([
            resolve_execution(engine.config.execution, t, engine.device, engine.config.update)
            == "scan" for t in targets
        ])
        # thin's kept count is a shape, so thinned segments submit directly
        # at their int step0 (as JAX's take the concrete-step0 path)
        if parse_collect(engine.config.collect)[0] == "thin":
            scan_exec = False
        # a run keeps the programs of its own targets only: the device
        # memory they hold stays that of one ladder
        programs = self._programs
        live = {id(t) for t in targets}
        for sig in [sig for sig in programs if sig[0] not in live]:
            del programs[sig]
        elem_shape = tuple(base_log_prob(target, init[0]).shape)
        stats = SwapStats(num_replicas, elem_shape)
        betas = torch.tensor(self.ladder.betas, dtype=torch.float32).to(engine.device)

        states = [init[r] for r in range(num_replicas)]
        pieces = [[] for _ in range(num_replicas)]
        acc = [None] * num_replicas
        swaps = []  # (host active mask, device accept mask) per swap event
        step = 0
        while step < n_steps:
            seg = min(self.swap_every, n_steps - step)
            with telemetry.span(
                "tempering.segment", step0=step, seg=seg, replicas=num_replicas,
            ):
                for r in range(num_replicas):
                    plan = RunPlan(
                        target=targets[r], n_steps=seg, init_words=states[r], key=key,
                        chain_id=chain_id + r, step0=step,
                    )
                    if _observe is not None:
                        _observe("segment", plan)
                    if scan_exec:
                        res = _scan_segment(programs, engine, targets[r], seg, chain_id + r,
                                            key, states[r], step)
                    else:  # a kernel segment takes its step0 as an operand
                        res = engine.submit(plan).result
                    states[r] = res.final_words
                    pieces[r].append(res.samples)
                    acc[r] = res.accept_count if acc[r] is None else acc[r] + res.accept_count
            step += seg
            if step < n_steps and num_replicas > 1:
                with telemetry.span(
                    "tempering.swap", abs_step=step,
                    parity=(step // self.swap_every - 1) % 2,
                ):
                    states = self._swap(key, target, states, step, betas, swaps, _observe)
                telemetry.counter("tempering_swap_rounds_total", "swap sweeps run").inc()

        if swaps:  # one copy to the host for the whole run
            accepts = torch.stack([a for _, a in swaps]).cpu().numpy()
            for (active, _), accept in zip(swaps, accepts):
                stats.record(active, accept)
        samples = torch.stack(
            [p[0] if len(p) == 1 else torch.cat(p, 0) for p in pieces]
        )
        accept_count = torch.stack(acc)
        final_words = torch.stack(states)
        return TemperedResult(
            samples=samples,
            accept_count=accept_count,
            acceptance_rate=_acceptance_rate(accept_count, n_steps),
            final_words=final_words,
            final_logp=torch.stack(
                [base_log_prob(target, s) for s in states]
            ).to(torch.float32),
            swap=stats,
            n_steps=n_steps,
            betas=self.ladder.betas,
        )

    def _swap(self, key, target, states, abs_step: int, betas, swaps: list, observe=None):
        """One even/odd adjacent-pair swap sweep at absolute step
        ``abs_step`` (a multiple of swap_every); appends the sweep's
        (active, accept) masks to ``swaps``."""
        num_replicas = len(states)
        f = torch.stack([base_log_prob(target, s) for s in states]).to(torch.float32)
        elem_ndim = f.ndim - 1
        expand = (slice(None),) + (None,) * elem_ndim
        delta = (betas[:-1] - betas[1:])[expand] * (f[1:] - f[:-1])

        # the swap test reads only the uniform: flip planes are not drawn
        # (the u stream is unchanged)
        swap_key = chain_key(key, SWAP_STREAM_ID)
        _, u = self.engine.randomness.chunk(
            swap_key, abs_step, 1, (num_replicas - 1, *f.shape[1:]), 1, need_flips=False,
        )
        parity = (abs_step // self.swap_every - 1) % 2
        active = (torch.arange(num_replicas - 1, device=f.device) % 2) == parity
        if observe is not None:
            observe("swap", delta, u[0], active[expand])
        accept = swap_accept(delta, u[0], active[expand])

        stacked = torch.stack(states)                  # (R, *state_shape)
        pad = torch.zeros((1, *accept.shape[1:]), dtype=torch.bool, device=f.device)
        up = torch.cat([accept, pad], 0)               # slot r <- r+1
        down = torch.cat([pad, accept], 0)             # slot r <- r-1
        # the per-element decision covers the trailing state dims (a
        # lattice element is a whole (H, W) configuration)
        trail = stacked.ndim - 1 - elem_ndim
        up_b = up.reshape(*up.shape, *([1] * trail))
        down_b = down.reshape(*down.shape, *([1] * trail))
        nxt = torch.cat([stacked[1:], stacked[-1:]], 0)
        prv = torch.cat([stacked[:1], stacked[:-1]], 0)
        swapped = torch.where(up_b, nxt, torch.where(down_b, prv, stacked))

        swaps.append(((np.arange(num_replicas - 1) % 2) == parity, accept))
        return [swapped[r] for r in range(num_replicas)]

    def tie_events(
        self, key, target, n_steps: int, init_words, *, chain_id: int = 0, logp_ulps: int = 0,
    ) -> dict:
        """Replay the run and count its tie events: the only draws where
        two implementations of ``exp`` (XLA's, PyTorch's, CUDA's
        ``expf``) may decide differently, so where two executors or
        packages may part.  ``moves``: within-replica draws, by the
        kernels' helpers (``kernels/mh/ref.py:tie_events`` on a table
        replica, widened by ``logp_ulps``; ``kernels/gibbs/ref.py:
        chain_ties`` on a lattice); ``swaps``: swap uniforms within one ULP
        of ``exp(min(delta, 0))`` on an active pair, or 0 at the flush."""
        from repro_torch.kernels.gibbs import ref as gibbs_ref
        from repro_torch.kernels.mh import ref as mh_ref

        engine = self.engine
        key = engine._key(key)
        backend = engine.randomness
        counts = {"moves": 0, "swaps": 0}

        def observe(kind, *args):
            if kind == "segment":
                (plan,) = args
                ck = chain_key(key, plan.chain_id)
                init = engine._words(plan.init_words)
                shape = tuple(init.shape)
                if engine.config.update == "gibbs":
                    _, u = backend.chunk(ck, plan.step0, plan.n_steps, shape, 1,
                                         need_flips=False)
                    ties = gibbs_ref.chain_ties(init, u, plan.target.logit_spec,
                                                plan.step0 % 2)
                else:
                    nbits = plan.target.nbits
                    flips, u = backend.chunk(ck, plan.step0, plan.n_steps, shape, nbits)
                    ties = mh_ref.tie_events(plan.target.table, init, flips, u, nbits,
                                             logp_ulps=logp_ulps)
                counts["moves"] += int(ties.shape[0])
            else:
                delta, u, active = args
                e = torch.exp(torch.minimum(delta, torch.zeros_like(delta)))
                ulp = torch.nextafter(e, torch.full_like(e, float("inf"))) - e
                near = (torch.abs(u - e) <= ulp) | (
                    (u == 0) & (torch.abs(e - FLUSH) <= FLUSH * 2.0**-20))
                counts["swaps"] += int((active & torch.isfinite(delta) & near).sum())

        self.run(key, target, n_steps, init_words, chain_id=chain_id, _observe=observe)
        return counts
