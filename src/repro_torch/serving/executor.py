"""The packed batch executor — the PyTorch port of
``repro.serving.executor``.

``PackedExecutor`` owns ``n_slots`` request slots and advances them in
lock-step ``chunk_steps`` segments.  Admission and retirement happen
only **between** chunks, and the packed batch is bit-identical to solo
runs because each slot replays exactly the solo call:

  * slot state is the engine carry with a leading slot axis, handed to
    the next segment and then deleted (``dispatch.poison_donated``) —
    stored *flat* (one zero-padded vector per slot, words and logp)
    under scan execution so heterogeneous workload members share the
    pool, and shaped under pallas (kernel geometry is per workload).
    Each segment writes its final state back into the same tensors, so
    one set serves the executor's life (a wider member joining a scan
    class re-pads it once);
  * each slot streams from its *request's* key (``PRNGKey(seed)`` split
    exactly as the JAX package's ``launch.sample`` does), so the stream
    belongs to the request, never to the slot;
  * each slot carries its absolute step as the engine's ``step0``; the
    kernels take it as a per-column / per-lattice operand, so slots at
    different absolute steps advance in one launch and a request joining
    mid-flight continues the exact stream of its solo run.

**Shape classes**: under scan execution the member table is open —
``add_member`` registers another workload; under pallas execution an
executor is a single-member class (one kernel call over all slots a
chunk, ``dispatch.make_pallas_advance_fn``).

Per-request collection: the segment collects ``"all"`` iff any active
request keeps samples (else ``"last"``); a ``thin:k`` request keeps the
strided slice of its slot's rows on absolute steps ``(step0 + t) % k ==
0``, the engine's own ``thin`` stream.

Retirement copies are issued right behind their own segment
(``dispatch.to_host``: pinned memory, ``non_blocking``, an event), so a
deferred finalize waits for that segment only, never for the kernels
queued after it: under pallas execution before the next segment
overwrites the carry.  ``advance_compiles`` counts the distinct advance
signatures (``dispatch.jit_cache_size``): the programs the JAX package
compiles.  Each is a compiled program of the port (on the card a CUDA
graph, replayed once a chunk), under scan and pallas execution alike.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import time

import numpy as np
import torch

from repro_torch import prng, telemetry, workloads
from repro_torch.kernels.rng import MASK32
from repro_torch.samplers import chain_key
from repro_torch.samplers.engine import parse_collect, resolve_execution
from repro_torch.serving import dispatch
from repro_torch.serving.dispatch import Carry, SegmentPipeline, to_host


@dataclasses.dataclass(frozen=True)
class _Member:
    """One workload group inside a shape class: the (engine, target)
    pair plus the request plumbing and this member's slot-state layout.
    ``index`` is the member's position in the class's member table."""

    name: str
    engine: object
    target: object
    state_shape: tuple
    request_init: object         # req -> (init_words, run_key, n_steps)
    default_steps: int | None
    index: int

    @property
    def size(self) -> int:
        return int(math.prod(self.state_shape))

    @property
    def carry_logp(self) -> bool:
        return self.engine.config.update == "mh"

    @property
    def rate_label(self) -> str:
        return "flip_rate" if self.engine.config.update == "gibbs" else "acceptance_rate"


@dataclasses.dataclass
class _Slot:
    """Executor-side bookkeeping for one admitted request."""

    req: object
    member: _Member
    remaining: int               # steps still to run
    mode: str                    # parsed collect mode: all | thin | last
    thin_k: int                  # stride under thin
    progress: int = 0            # absolute step == step0 of the next segment
    pieces: list = dataclasses.field(default_factory=list)  # HostCopy of kept rows
    acc: object = None           # per-site accept/flip accumulator (device)
    final_words: object = None   # HostCopy
    final_logp: object = None    # HostCopy


def _seed_key(seed: int, device) -> torch.Tensor:
    """``prng.PRNGKey(seed)`` made on ``device`` by fills (no copy from the
    host, which would wait for the card)."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = int(seed) & MASK32
    return key


def _workload_member_parts(
    name: str,
    *,
    randomness: str,
    execution: str,
    smoke: bool,
    device=None,
    **builder_kwargs,
):
    """(engine, target, state_shape, request_init, default_steps) for a
    workload group — engine + target built once (group key 0; for
    seed-dependent targets like spin_glass the group fixes the problem
    instance), requests supply per-request inits and streams.

    ``request_init`` replays the JAX package's solo-run derivation
    (``launch.sample``): ``PRNGKey(seed)`` -> split -> (builder init from
    k_init, chain stream from k_run) — so a packed request reproduces
    ``engine.run(k_run, target, n, init)`` bit for bit.
    """
    builder = workloads.WORKLOADS[name]
    params = inspect.signature(builder).parameters
    kwargs = {
        k: v
        for k, v in dict(
            randomness=randomness, backend=execution, smoke=smoke, device=device,
            **builder_kwargs,
        ).items()
        if k in params and v is not None
    }
    template = workloads.build(name, prng.PRNGKey(0), **kwargs)
    dev = template.engine.device

    def request_init(req):
        k_init, k_run = prng.split(_seed_key(req.seed, dev))
        wl = workloads.build(name, k_init, **kwargs)
        n = req.n_steps if req.n_steps else wl.n_steps
        return wl.init_words, k_run, n

    return (
        template.engine,
        template.target,
        tuple(template.init_words.shape),
        request_init,
        template.n_steps,
    )


def _uint32(words: np.ndarray) -> np.ndarray:
    """uint32 words from int64 (a copy) or int32 (the Gibbs kernels' {0, 1}
    spins: the same bits, a view)."""
    return words.view(np.uint32) if words.dtype == np.int32 else words.astype(np.uint32)


class PackedExecutor:
    """``n_slots`` heterogeneous requests packed into one advance call a
    chunk, on the engine's device.

    Construct via ``for_workload`` (the registry path the scheduler
    uses) or directly with an engine/target pair plus a
    ``request_init(req) -> (init_words, run_key, n_steps)`` callable.
    Additional workload members join a scan-execution executor via
    ``add_workload``/``add_member`` — the shape-class packing axis.
    ``mesh`` (a 1-D ``DeviceMesh``) shards the slot axis of the scan
    class call across its ranks (``dispatch.make_class_advance_fn``);
    pallas execution folds the slots into one kernel call on one device
    and refuses a mesh.
    """

    def __init__(
        self,
        engine,
        target,
        n_slots: int,
        state_shape: tuple,
        *,
        request_init,
        default_steps: int | None = None,
        chunk_steps: int | None = None,
        pipeline_depth: int = 2,
        clock=time.perf_counter,
        workload: str = "default",
        mesh=None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self._check_engine(engine)
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps or engine.config.chunk_steps)
        self.clock = clock
        self.mesh = mesh
        self.device = engine.device
        self.execution = resolve_execution(
            engine.config.execution, target, engine.device, engine.config.update
        )
        if mesh is not None and self.execution != "scan":
            raise ValueError(
                "mesh-sharded serving shards the slot axis of the scan "
                "class call — pallas execution folds slots into one "
                "kernel call on a single device (use execution='scan' "
                "with a mesh)"
            )
        self.members: list[_Member] = [
            _Member(
                name=workload, engine=engine, target=target,
                state_shape=tuple(state_shape), request_init=request_init,
                default_steps=default_steps, index=0,
            )
        ]
        self.pipeline = SegmentPipeline(pipeline_depth)
        self.advance_compiles = 0    # distinct advance signatures
        self._dummy_key = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._slots: list[_Slot | None] = [None] * self.n_slots
        self._keys: list = [self._dummy_key] * self.n_slots
        self.n_pad = self.members[0].size
        if self.execution == "scan":
            self.words = Carry(torch.zeros((self.n_slots, self.n_pad), dtype=torch.int64,
                                           device=self.device))
            self.logp = Carry(torch.zeros((self.n_slots, self.n_pad), dtype=torch.float32,
                                          device=self.device))
        else:
            self.words = Carry(torch.zeros((self.n_slots, *self.members[0].state_shape),
                                           dtype=torch.int64, device=self.device))
            self.logp = None
        self._rebuild_advance()

    @staticmethod
    def _check_engine(engine) -> None:
        if engine.config.num_chains != 1:
            raise ValueError(
                "the serving tier packs requests into the batch itself — "
                "configure the engine with num_chains=1 (got "
                f"{engine.config.num_chains})"
            )

    def _rebuild_advance(self) -> None:
        if self.execution == "scan":
            self._advance = dispatch.make_class_advance_fn(
                self.members, self.n_pad, self.n_slots, mesh=self.mesh
            )
        else:
            m = self.members[0]
            self._advance = dispatch.make_pallas_advance_fn(m.engine, m.target, m.state_shape)

    # -- construction from the workload registry -----------------------
    @classmethod
    def for_workload(
        cls,
        name: str,
        *,
        n_slots: int,
        randomness: str = "cim",
        execution: str = "scan",
        smoke: bool = True,
        chunk_steps: int | None = None,
        pipeline_depth: int = 2,
        clock=time.perf_counter,
        mesh=None,
        device=None,
        **builder_kwargs,
    ) -> "PackedExecutor":
        """An executor whose first member is workload ``name`` (see
        ``_workload_member_parts`` for the per-request derivation), on
        ``device`` (the card unless ``"cpu"`` is asked for)."""
        engine, target, shape, request_init, default_steps = _workload_member_parts(
            name, randomness=randomness, execution=execution, smoke=smoke, device=device,
            **builder_kwargs,
        )
        return cls(
            engine,
            target,
            n_slots,
            shape,
            request_init=request_init,
            default_steps=default_steps,
            chunk_steps=chunk_steps,
            pipeline_depth=pipeline_depth,
            clock=clock,
            workload=name,
            mesh=mesh,
        )

    # -- shape-class membership ----------------------------------------
    def member_for(self, workload: str | None) -> _Member:
        """The member serving ``workload`` (single-member executors
        accept any name — the direct-construction test path)."""
        if len(self.members) == 1:
            return self.members[0]
        for m in self.members:
            if m.name == workload:
                return m
        raise KeyError(
            f"workload {workload!r} is not a member of this shape class "
            f"({[m.name for m in self.members]})"
        )

    def has_member(self, workload: str) -> bool:
        return any(m.name == workload for m in self.members)

    def add_member(
        self, name, engine, target, state_shape, request_init, default_steps=None,
    ) -> _Member:
        """Register another workload group in this shape class (scan
        execution only — pallas kernel geometry is per workload).  Live
        slots keep advancing: the flat pool re-pads in place if the new
        member's state is wider."""
        if self.execution != "scan":
            raise ValueError(
                "pallas executors are single-member shape classes — the "
                "kernel call is specialised to one workload's state "
                "geometry; mixed pallas bursts run one executor per workload"
            )
        self._check_engine(engine)
        if resolve_execution(
            engine.config.execution, target, engine.device, engine.config.update
        ) != "scan":
            raise ValueError("shape-class members must resolve to scan execution")
        if engine.device != self.device:
            raise ValueError(
                f"a shape class runs on one device: {engine.device} != {self.device}"
            )
        if self.has_member(name):
            return self.member_for(name)
        m = _Member(
            name=name, engine=engine, target=target, state_shape=tuple(state_shape),
            request_init=request_init, default_steps=default_steps, index=len(self.members),
        )
        self.members.append(m)
        if m.size > self.n_pad:
            grow = m.size - self.n_pad
            self.words = Carry(torch.nn.functional.pad(self.words.tensor, (0, grow)))
            self.logp = Carry(torch.nn.functional.pad(self.logp.tensor, (0, grow)))
            self.n_pad = m.size
        self._rebuild_advance()
        return m

    def add_workload(
        self,
        name: str,
        *,
        randomness: str = "cim",
        execution: str = "scan",
        smoke: bool = True,
        device=None,
        **builder_kwargs,
    ) -> _Member:
        """``add_member`` fed from the workload registry (the scheduler's
        shape-class path)."""
        parts = _workload_member_parts(
            name, randomness=randomness, execution=execution, smoke=smoke,
            device=self.device if device is None else device, **builder_kwargs,
        )
        return self.add_member(name, *parts)

    # -- primary-member views (single-workload API compatibility) ------
    @property
    def engine(self):
        return self.members[0].engine

    @property
    def target(self):
        return self.members[0].target

    @property
    def state_shape(self) -> tuple:
        return self.members[0].state_shape

    @property
    def request_init(self):
        return self.members[0].request_init

    @property
    def default_steps(self):
        return self.members[0].default_steps

    @property
    def rate_label(self) -> str:
        return self.members[0].rate_label

    # -- slot pool ------------------------------------------------------
    def has_free_slot(self) -> bool:
        return any(s is None for s in self._slots)

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    def admit(self, req) -> int:
        """Place a request in a free slot (between chunks only — callers
        never see a partially-advanced admission)."""
        try:
            slot = next(i for i, s in enumerate(self._slots) if s is None)
        except StopIteration:
            raise RuntimeError("no free slot — check has_free_slot()") from None
        member = self.member_for(getattr(req, "workload", None))
        init, k_run, n_steps = member.request_init(req)
        words0 = member.engine._words(init)
        if tuple(words0.shape) != member.state_shape:
            raise ValueError(
                f"request init shape {tuple(words0.shape)} != member state "
                f"shape {member.state_shape} — one member serves one "
                f"workload group"
            )
        mode, k = parse_collect(req.collect)
        if self.execution == "scan":
            row = self.words.tensor[slot]
            row.zero_()
            row[:member.size] = words0.reshape(-1)
            if member.carry_logp:
                lp = self.logp.tensor[slot]
                lp.zero_()
                lp[:member.size] = member.target.log_prob(words0).to(torch.float32).reshape(-1)
        else:
            self.words.tensor[slot] = words0
        # the stream key of the slot's advance: the request key itself for a
        # scan class (engine.run folds it), folded once here for a kernel call
        key = member.engine._key(k_run)
        self._keys[slot] = key if self.execution == "scan" else chain_key(key, 0)
        self._slots[slot] = _Slot(
            req=req, member=member, remaining=int(n_steps), mode=mode, thin_k=k,
        )
        req.slot = slot
        req.rate_label = member.rate_label
        req.t_admit = self.clock()
        return slot

    # -- the chunk loop -------------------------------------------------
    def advance_chunk(self) -> list:
        """Advance every active slot one segment; returns the requests
        that finished (their results materialise when the dispatch
        pipeline flushes — ``drain()`` forces it)."""
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return []
        # the segment never overshoots the shortest remaining budget, so
        # every retirement lands exactly on a chunk boundary
        seg = min(self.chunk_steps, *(self._slots[i].remaining for i in active))
        with telemetry.span(
            "serving.segment", seg=seg, active=len(active), execution=self.execution,
        ):
            if self.execution == "scan":
                retired = self._advance_scan(active, seg)
            else:
                retired = self._advance_pallas(active, seg)
        telemetry.counter(
            "serving_segments_total", "packed segments dispatched"
        ).inc(execution=self.execution)
        telemetry.counter(
            "serving_slot_steps_total", "slot-steps advanced"
        ).inc(seg * len(active))
        finished = []
        if retired:
            batch = []
            for i in retired:
                s = self._slots[i]
                self._slots[i] = None          # slot free for the next admit
                self._keys[i] = self._dummy_key
                batch.append(s)
                finished.append(s.req)
            self.pipeline.push(lambda fs=batch: self._finalize_batch(fs))
        return finished

    def _segment_inputs(self, active):
        """(collect, step0s, keys): every slot's absolute step as an (S,)
        int64 host tensor (0 for a free slot), staged into the program,
        and the (S, 2) stack of its stream key."""
        collect = (
            "all" if any(self._slots[i].mode != "last" for i in active) else "last"
        )
        step0s = torch.tensor([s.progress if s else 0 for s in self._slots],
                              dtype=torch.int64)
        keys = torch.stack(self._keys)
        return collect, step0s, keys

    def _count_compiles(self, before: int) -> None:
        grew = dispatch.jit_cache_size(self._advance) - before
        if grew > 0:
            self.advance_compiles += grew
            telemetry.counter(
                "serving_advance_compiles_total",
                "compiled packed advance programs",
            ).inc(grew, execution=self.execution)

    def _advance_scan(self, active, seg: int) -> list:
        """One class call over the slots (dispatch.make_class_advance_fn):
        the flat (words, logp) carries, written in place, the slots' (S,
        2) keys and (S,) int64 step bases, staged, and each slot's member
        on the host (-1 for a free slot, which runs nothing).  The new
        ``Carry`` objects wrap the same tensors; the old ones are poisoned
        all the same."""
        collect, step0s, keys = self._segment_inputs(active)
        layout = tuple(s.member.index if s else -1 for s in self._slots)
        old_words, old_logp = self.words, self.logp
        before = dispatch.jit_cache_size(self._advance)
        samples, words, logp, acc = self._advance(
            old_words.tensor, old_logp.tensor, keys, step0s, seg=seg, collect=collect,
            layout=layout,
        )
        self._count_compiles(before)
        self.words, self.logp = Carry(words), Carry(logp)
        # the old carries are dead from here on — make stale reads loud
        dispatch.poison_donated(old_words, old_logp)

        def rows(i, m):
            return samples[i][:, :m.size].reshape(-1, *m.state_shape)

        def unflat(buf, i, m):
            return buf[i, :m.size].reshape(m.state_shape)

        return self._bookkeep(
            active, seg, collect, rows,
            lambda i, m: unflat(acc, i, m),
            lambda i, m: unflat(words, i, m),
            lambda i, m: unflat(logp, i, m),
        )

    def _advance_pallas(self, active, seg: int) -> list:
        """One kernel call over all slots (dispatch.make_pallas_advance_fn):
        the shaped words carry, written in place, and each slot's key words
        and step base, staged as an (S,) int64 tensor.  The new ``Carry``
        wraps the same tensor; the old one is poisoned all the same."""
        collect, step0s, keys = self._segment_inputs(active)
        old_words = self.words
        before = dispatch.jit_cache_size(self._advance)
        samples, words, acc = self._advance(
            old_words.tensor, keys, step0s, seg=seg, collect=collect,
        )
        self._count_compiles(before)
        self.words = Carry(words)
        dispatch.poison_donated(old_words)
        return self._bookkeep(
            active, seg, collect,
            lambda i, m: samples[i],
            lambda i, m: acc[i],
            lambda i, m: words[i],
            # only a retiring slot's: the solo run's final log-prob
            lambda i, m: dispatch.final_logp(m.engine, m.target, words[i]),
        )

    def _bookkeep(self, active, seg, collect, rows_of, acc_of, words_of, logp_of) -> list:
        """Per-slot segment bookkeeping: issue the copies of kept rows and
        retirement payloads to the host NOW, right behind this segment and
        before the next one overwrites a carry written in place (the
        getters read the segment's outputs, never a deleted carry),
        advance progress, collect retirees."""
        retired = []
        for i in active:
            s = self._slots[i]
            m = s.member
            if collect == "all" and s.mode != "last":
                r = rows_of(i, m)
                if s.mode == "all":
                    s.pieces.append(to_host(r))
                else:  # thin: strided slice on absolute steps
                    i0 = (-s.progress) % s.thin_k
                    if i0 < seg:
                        s.pieces.append(to_host(r[i0::s.thin_k]))
            a = acc_of(i, m)
            s.acc = a if s.acc is None else s.acc + a
            s.progress += seg
            s.remaining -= seg
            if s.remaining == 0:
                s.final_words = to_host(words_of(i, m))
                s.final_logp = to_host(logp_of(i, m))
                s.acc = to_host(s.acc)
                retired.append(i)
        return retired

    # -- retirement -----------------------------------------------------
    def _finalize_batch(self, batch: list) -> None:
        """Finalize a batch of retired slots under one span — the span
        duration is the wait for their copies the pipeline deferred."""
        with telemetry.span("serving.finalize", retired=len(batch)):
            for s in batch:
                self._finalize(s)
        telemetry.counter(
            "serving_requests_retired_total", "requests finalized"
        ).inc(len(batch))
        for s in batch:
            req = s.req
            wl = getattr(req, "workload", "?")
            wait = getattr(req, "wait_s", None)
            if wait is not None:
                telemetry.histogram(
                    "serving_wait_seconds", "arrival -> admission"
                ).observe(wait, workload=wl)
            service = getattr(req, "service_s", None)
            if service is not None:
                telemetry.histogram(
                    "serving_service_seconds", "admission -> materialised"
                ).observe(service, workload=wl)

    def _finalize(self, s: _Slot) -> None:
        """Host-side retirement: materialise the request's payload (the
        JAX package's dtypes: uint32 words, int32 counts, float32
        log-probs) and stamp delivery time."""
        req = s.req
        if s.pieces:
            rows = [p.numpy() for p in s.pieces]
            req.samples = _uint32(rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0))
        else:
            req.samples = np.zeros((0, *s.member.state_shape), np.uint32)
        req.final_words = _uint32(s.final_words.numpy())
        req.final_logp = s.final_logp.numpy()
        req.accept_count = s.acc.numpy()
        total = max(1, s.progress * int(np.prod(s.member.state_shape)))
        req.acceptance_rate = float(req.accept_count.sum()) / total
        req.t_done = self.clock()

    def drain(self) -> None:
        """Flush the deferred finalize pipeline (every retired request's
        result is host-materialised after this returns)."""
        self.pipeline.drain()
