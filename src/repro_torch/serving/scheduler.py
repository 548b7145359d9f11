"""Request queue + slot assignment — the PyTorch port of
``repro.serving.scheduler`` (host code, copied as it is).

``ServeRequest`` is the serving tier's unit of work: a workload name, a
step budget, a seed, a collection mode and an arrival time.  The
``Scheduler`` owns a FIFO of pending requests and one ``PackedExecutor``
per distinct workload name; between chunks it admits ready requests into
free slots (strict arrival order — the queue head blocks until its
workload group has a free slot) and collects retired ones.

Determinism contract: a request's sample stream is a function of its
``(workload, seed, n_steps, collect)`` alone — never of which slot it
lands in, when it was admitted, or who shares the batch.  The executor
guarantees this via per-request keys + the ``step0`` resume axis; the
scheduler only decides *when* work happens, so admission policy can
change without touching numerics.

Timestamps (``t_arrive``/``t_admit``/``t_done``) share one clock, the
scheduler's serve-loop timebase (seconds from loop start).  ``t_done``
is stamped when the host *materialises* the result — after the dispatch
pipeline's deferred finalize — so latency percentiles measure delivery,
not device completion.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

import numpy as np

from repro_torch import telemetry
from repro_torch.samplers.engine import parse_collect
from repro_torch.serving.executor import PackedExecutor


@dataclasses.dataclass
class ServeRequest:
    """One sampling request, plus the result/latency fields the serving
    tier fills in as it moves through the system.

    ``n_steps=None`` means the workload group's default step budget;
    ``collect`` is the engine's collection axis per request ("last" is
    the serving default — most clients want the final state, and it
    keeps the packed batch O(state)).  ``t_arrive`` is an offset in
    seconds from the serve loop's start (0 = already waiting).
    """

    rid: int
    workload: str = "ising"
    n_steps: int | None = None
    seed: int = 0
    collect: str = "last"
    t_arrive: float = 0.0

    # filled in by the executor
    t_admit: float | None = None
    t_done: float | None = None
    slot: int | None = None
    samples: np.ndarray | None = None       # kept stream (K, *state) uint32
    final_words: np.ndarray | None = None
    final_logp: np.ndarray | None = None
    accept_count: np.ndarray | None = None  # per-site, summed over segments
    acceptance_rate: float | None = None
    rate_label: str = "acceptance_rate"     # "flip_rate" under gibbs

    def __post_init__(self):
        parse_collect(self.collect)  # fail at submission, not admission
        if self.n_steps is not None and self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")

    @property
    def wait_s(self) -> float | None:
        """Queue wait: arrival -> slot admission."""
        return None if self.t_admit is None else self.t_admit - self.t_arrive

    @property
    def service_s(self) -> float | None:
        """In-slot time: admission -> result materialised on the host."""
        if self.t_done is None or self.t_admit is None:
            return None
        return self.t_done - self.t_admit

    @property
    def latency_s(self) -> float | None:
        """End-to-end: arrival -> result materialised on the host."""
        return None if self.t_done is None else self.t_done - self.t_arrive


class FIFOQueue:
    """Arrival-ordered FIFO with wall-clock gating.

    Items are served strictly in push order; ``pop_ready(now)`` returns
    the head only once its arrival time has passed (push in arrival
    order — gating is head-based).  ``push_front`` returns an item the
    caller could not place (full slot pool) without losing its turn.
    Shared by the engine scheduler and the legacy ``launch.serve``
    overflow queue.
    """

    def __init__(self):
        self._q: deque = deque()

    def push(self, item, t_arrive: float = 0.0) -> None:
        self._q.append((float(t_arrive), item))

    def push_front(self, item, t_arrive: float = 0.0) -> None:
        self._q.appendleft((float(t_arrive), item))

    def pop_ready(self, now: float = math.inf):
        """The head item if it has arrived by ``now``, else None."""
        if self._q and self._q[0][0] <= now:
            return self._q.popleft()[1]
        return None

    def next_arrival(self) -> float | None:
        return self._q[0][0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class Scheduler:
    """Packs a request stream into executor slots, FIFO, between chunks.

    One ``PackedExecutor`` per **shape class**, created/extended on
    first use with this scheduler's group settings (randomness /
    execution / smoke / builder kwargs).  Under scan execution every
    uint32-state workload shares ONE class — a new workload name joins
    the existing executor as another member, so a mixed ising+gmm burst
    fills one executor's slot axis.  Under pallas execution a class is
    one workload's kernel geometry, so mixed bursts run one packed
    kernel launch per workload and chunk (never one per slot).  Seed-dependent *targets*
    (spin_glass couplings) are fixed by the group — the service hosts
    one problem instance and requests are independent chains on it;
    per-request seeds drive the init and the chain stream (see
    ``PackedExecutor.for_workload``).

    ``device`` is where every executor runs (the port's device rule:
    the card unless ``"cpu"`` is asked for).  ``mesh`` (a 1-D
    ``DeviceMesh``, one process per device) shards each class call's slot
    axis across its ranks through the "chains" sharding rule — slots
    never communicate, so sharded serving equals unsharded word for word
    (scan execution only).  Every rank runs this loop on the same
    requests; they admit on rank 0's clock, so all ranks pack the same
    slots and make the same calls.
    """

    def __init__(
        self,
        n_slots: int = 4,
        *,
        randomness: str = "cim",
        execution: str = "scan",
        smoke: bool = True,
        chunk_steps: int | None = None,
        pipeline_depth: int = 2,
        workload_kwargs: dict | None = None,
        mesh=None,
        device=None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.randomness = randomness
        self.execution = execution
        self.smoke = smoke
        self.chunk_steps = chunk_steps
        self.pipeline_depth = pipeline_depth
        self.workload_kwargs = dict(workload_kwargs or {})
        self.device = device
        self.mesh = mesh
        self.pending = FIFOQueue()
        self.executors: dict[tuple, PackedExecutor] = {}   # by shape class
        self._by_workload: dict[str, PackedExecutor] = {}
        self.done: list[ServeRequest] = []
        self._t0: float | None = None
        # optional telemetry.JsonlFlusher — the serve loop calls
        # maybe_flush() between chunks (rate-limited, host-side only)
        self.metrics_flusher = None

    # -- clock: one timebase for every stamp ---------------------------
    def clock(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0 + self._skip

    _skip: float = 0.0  # virtual fast-forward (non-realtime idle gaps)

    def _admission_clock(self) -> float:
        """The time admission reads: this process's clock, or with a mesh
        rank 0's, broadcast to every rank, so that arrivals between two
        ranks' readings cannot split their admissions."""
        now = self.clock()
        if self.mesh is None:
            return now
        import torch
        import torch.distributed as dist

        group = self.mesh.get_group()
        t = torch.tensor([now], dtype=torch.float64, device=self.mesh.device_type)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return float(t.item())

    # -- queue + groups ------------------------------------------------
    def submit(self, request: ServeRequest) -> None:
        self.pending.push(request, request.t_arrive)

    def _class_key(self, workload: str) -> tuple:
        """The shape-class identity a workload's requests pack under:
        scan packs every uint32-state workload into one flat-state class
        program; pallas classes are one workload's kernel geometry."""
        if self.execution == "pallas":
            return ("pallas", workload)
        return ("scan", "uint32")

    def executor_for(self, workload: str) -> PackedExecutor:
        ex = self._by_workload.get(workload)
        if ex is not None:
            return ex
        key = self._class_key(workload)
        ex = self.executors.get(key)
        if ex is None:
            ex = PackedExecutor.for_workload(
                workload,
                n_slots=self.n_slots,
                randomness=self.randomness,
                execution=self.execution,
                smoke=self.smoke,
                chunk_steps=self.chunk_steps,
                pipeline_depth=self.pipeline_depth,
                clock=self.clock,
                mesh=self.mesh,
                device=self.device,
                **self.workload_kwargs,
            )
            self.executors[key] = ex
        else:
            ex.add_workload(
                workload,
                randomness=self.randomness,
                execution=self.execution,
                smoke=self.smoke,
                device=self.device,
                **self.workload_kwargs,
            )
        self._by_workload[workload] = ex
        return ex

    @property
    def shape_classes(self) -> int:
        """Distinct shape classes (executors) currently serving requests."""
        return len(self.executors)

    @property
    def compiled_programs(self) -> int:
        """Advance signatures across all classes: the programs the JAX
        package compiles per burst (``PackedExecutor.advance_compiles``).
        Every class keeps a compiled program for each (on the card a CUDA
        graph), scan and kernel classes alike."""
        return sum(ex.advance_compiles for ex in self.executors.values())

    @property
    def active(self) -> int:
        return sum(ex.active_count for ex in self.executors.values())

    def admit_ready(self, now: float = math.inf) -> int:
        """Admit arrived requests into free slots, strict FIFO.  Stops at
        the first request whose group is full (head-of-line blocking is
        the policy, not an accident — arrival order is the fairness
        contract)."""
        admitted = 0
        while True:
            req = self.pending.pop_ready(now)
            if req is None:
                break
            ex = self.executor_for(req.workload)
            if not ex.has_free_slot():
                self.pending.push_front(req, req.t_arrive)
                break
            ex.admit(req)
            telemetry.counter(
                "serving_requests_admitted_total", "requests admitted"
            ).inc(workload=req.workload)
            admitted += 1
        return admitted

    def step(self) -> list[ServeRequest]:
        """Advance every group one chunk; returns requests retired this
        chunk (results materialise once the dispatch pipeline flushes)."""
        retired: list[ServeRequest] = []
        for ex in self.executors.values():
            retired.extend(ex.advance_chunk())
        self.done.extend(retired)
        return retired

    def drain(self) -> None:
        for ex in self.executors.values():
            ex.drain()

    # -- the serve loop ------------------------------------------------
    def serve(
        self, requests=(), *, realtime: bool = False
    ) -> list[ServeRequest]:
        """Drive submitted + given requests to completion.

        The loop alternates admit -> advance-one-chunk; when every slot
        is idle but arrivals are still due, it either sleeps until the
        next arrival (``realtime=True``) or fast-forwards the clock —
        latency stats are identical either way, the non-realtime path
        just doesn't burn wall time on synthetic arrival gaps.
        """
        for r in sorted(requests, key=lambda r: r.t_arrive):
            self.submit(r)
        while self.pending or self.active:
            self.admit_ready(self._admission_clock())
            telemetry.gauge(
                "serving_queue_depth", "pending requests"
            ).set(len(self.pending))
            telemetry.gauge(
                "serving_active_slots", "occupied slots"
            ).set(self.active)
            if self.metrics_flusher is not None:
                self.metrics_flusher.maybe_flush()
            if self.active:
                self.step()
                continue
            nxt = self.pending.next_arrival()
            if nxt is None:  # pragma: no cover - loop condition guards this
                break
            gap = nxt - self.clock()
            if gap > 0:
                if realtime:
                    time.sleep(min(gap, 0.05))
                else:
                    self._skip += gap
        self.drain()
        return self.done


def latency_summary(requests) -> dict:
    """Throughput + latency percentiles over finished requests — the
    row shape ``bench_serving`` and ``serve_engine`` both report.

    Latency decomposes as wait (arrival -> admission, the queueing cost
    the *scheduler* controls) + service (admission -> host-materialised
    result, the cost the *executor* controls); the split is reported so
    an SLO breach points at the right layer.
    """
    done = [r for r in requests if r.t_done is not None]
    if not done:
        return {"n_requests": 0}
    lat = np.asarray([r.latency_s for r in done], np.float64)
    wait = np.asarray([r.wait_s for r in done], np.float64)
    service = np.asarray([r.service_s for r in done], np.float64)
    span = max(
        max(r.t_done for r in done) - min(r.t_arrive for r in done), 1e-9
    )
    return {
        "n_requests": len(done),
        "requests_per_s": round(len(done) / span, 2),
        "p50_latency_s": round(float(np.percentile(lat, 50)), 4),
        "p99_latency_s": round(float(np.percentile(lat, 99)), 4),
        "mean_wait_s": round(float(wait.mean()), 4),
        "p99_wait_s": round(float(np.percentile(wait, 99)), 4),
        "mean_service_s": round(float(service.mean()), 4),
        "p50_service_s": round(float(np.percentile(service, 50)), 4),
        "p99_service_s": round(float(np.percentile(service, 99)), 4),
    }
