"""Packed segment programs + host/device overlap for the serving tier —
the PyTorch port of ``repro.serving.dispatch``.

  * ``make_class_advance_fn`` advances a *shape class* under scan
    execution: every member workload's slots in one call.  JAX runs one
    compiled ``jit(vmap(lax.switch(...)))`` over the slot axis; the port
    runs, for every occupied slot, its own member's exact solo call
    (``engine.submit(RunPlan(..., step0=<slot step base, a card
    tensor>))``), stored flat and zero-padded to the class width, as JAX
    does.  With a ``mesh`` the slot axis is sharded by the "chains" rule
    (the JAX package's ``_slot_axis_wrap``): each rank runs the slots of
    its block and an all-gather joins the blocks.
  * ``make_pallas_advance_fn`` is the pallas edition: all slots of a
    class fold into ONE kernel call per chunk — slot-major into the MH
    column axis (per-column key words and step base ``t0c``) or the Gibbs
    lattice axis (per-lattice ``t0b`` / ``parity0``) — so slots at
    different absolute steps advance in one launch on their solo streams.
    Host/cim randomness draws each slot's operands at its own offset and
    folds them.
  * Both advances run through a compiled program of each ``(seg,
    collect)`` (``repro_torch.compiled``), the slot keys and step bases
    staged into it: on the card a kernel class's chunk is one CUDA graph
    replay.  A scan class's program is cut into one graph for every
    slot's every member's call (a section) and the graphs between them,
    and a chunk replays each occupied slot's own member's section only,
    so one program serves every slot layout.
  * ``SegmentPipeline`` bounds how far host-side finalisation may lag
    the device; the executor issues each retiring slot's copies to the
    host (``to_host``: pinned memory, ``non_blocking``, an event) right
    behind its own segment, so a finalize waits for that segment alone.

Donation: JAX donates the carried slot state to the next segment and
deletes the old buffers.  Both advances write the final state back into
the carries they were given, as a donated buffer is reused, so the
executor keeps one words tensor (and under scan one logp tensor) for its
life and a program holds them.  The executor hands the old ``Carry`` to
``poison_donated``, which drops its tensor, so a stale read raises
``RuntimeError`` instead of seeing an outdated state.
(Resizing the tensor's storage to zero would free it too, but a read of
such a tensor is not checked: ``x + 1`` on it crashed the process under
torch 2.13 on the CPU.)

``jit_cache_size`` counts the distinct ``(seg, collect)`` signatures an
advance function has run: the programs the JAX package compiles for
them, one ``compiled.Program`` each (on the CPU a record of the
signature, the body run directly).
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

from repro_torch import compiled, telemetry
from repro_torch.kernels.gibbs import ops as gibbs_ops
from repro_torch.kernels.mh import ops as mh_ops
from repro_torch.samplers import RunPlan
from repro_torch.samplers.engine import (
    _chains_fold_mh,
    _fused_gibbs_logit,
    _fused_key_cols,
    _gibbs_logp,
    _shard_over_chains,
)


class Carry:
    """The carried slot state between segments, the port's counterpart of
    a donated ``jax.Array``: ``tensor`` until ``delete()``, then every
    read (``tensor``, ``np.asarray``) raises ``RuntimeError``."""

    __slots__ = ("_t",)

    def __init__(self, t: torch.Tensor):
        self._t = t

    @property
    def tensor(self) -> torch.Tensor:
        if self._t is None:
            raise RuntimeError(
                "this slot carry was donated to a later segment and poisoned; "
                "read the segment's outputs instead"
            )
        return self._t

    def delete(self) -> None:
        self._t = None

    def is_deleted(self) -> bool:
        return self._t is None

    def __array__(self, dtype=None, copy=None):
        a = self.tensor.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def jit_cache_size(fn) -> int:
    """Distinct ``(seg, collect)`` signatures ``fn`` (an advance function
    of this module) has run: its programs; 0 for any other callable."""
    return len(getattr(fn, "programs", ()))


def poison_donated(*carries) -> None:
    """Make the donation contract loud: delete the carries that were just
    handed to an advance call, so any later read raises RuntimeError."""
    for c in carries:
        delete = getattr(c, "delete", None)
        is_deleted = getattr(c, "is_deleted", None)
        if delete is None or is_deleted is None:
            continue
        if not c.is_deleted():
            delete()


class HostCopy:
    """A tensor on its way to the host: the copy was issued when this was
    made; ``numpy()`` waits for it (for a card, on its event only)."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor = tensor
        self.event = event

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.tensor.numpy()


def to_host(t: torch.Tensor) -> HostCopy:
    """Issue the copy of ``t`` to the host now: on a card into pinned
    memory, ``non_blocking``, with an event recorded behind it on the
    current stream; on the CPU a clone."""
    if t.device.type != "cuda":
        return HostCopy(t.detach().clone())
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return HostCopy(out, event)


def make_class_advance_fn(members, n_pad: int, n_slots: int, mesh=None):
    """The packed-segment program of one *shape class* under scan
    execution.

    Returns ``advance(words, logp, keys, step0s, *, layout, seg, collect)``
    -> ``(samples, words, logp, accept)``, each with a leading slot axis
    and flat state vectors zero-padded to ``n_pad``.  ``words`` and
    ``logp`` are the carries, written in place and returned; ``keys`` is
    the (S, 2) stack of the slots' request keys and ``step0s`` the (S,)
    int64 tensor of their step bases, both staged; ``layout`` is each
    slot's member index on the host, -1 for a free slot.  Slot s runs its
    member m's solo call ``m.engine.submit(RunPlan(m.target, seg,
    words[s, :m.size], key=keys[s], step0=step0s[s], collect=collect))``
    with ``step0s[s]`` a 0-d tensor on the card, so the packed batch is
    bit-identical to solo runs whoever shares it.  A free slot runs
    nothing and holds zeros: its outputs reach no request.

    MH members carry (words, logp) across segments (``init_logp``);
    Gibbs members read only words and return the final per-site
    conditional log-prob in the logp lane.

    ``mesh`` (a 1-D ``DeviceMesh``, one process per device) shards the
    slot axis through the "chains" rule, as the engine shards chains
    (``samplers.engine._shard_over_chains``): when the mesh divides
    ``n_slots`` each rank runs the occupied slots of its contiguous block
    and ``all_gather_into_tensor`` joins the four outputs along the slot
    axis inside the program; otherwise every rank runs every slot.  Slots
    never communicate, so the result equals the unsharded call word for
    word.  Every rank must make the same calls with the same ``layout``
    (the scheduler admits on one clock for that).

    One ``compiled.Program`` a ``(seg, collect)`` (``_compiled_advance``),
    as JAX compiles one for its ``switch`` under ``vmap``: on the card its
    capture is cut into a graph for every slot's every member's call (a
    section, ``compiled.section``) and the graphs between them, and a
    chunk replays each occupied slot's own member's section and no other,
    so it costs the occupied slots' own work, whatever the layout.  The
    capture's warm-up runs every section once (and keeps the layout's), so
    no section's first call, which may fill a cache, is left to the graph.
    """
    members = list(members)
    device = members[0].engine.device

    def branch(m, w_flat, lp_flat, key, step0, seg, collect):
        size = m.size
        kwargs = {}
        if m.carry_logp:
            kwargs["init_logp"] = lp_flat[:size].reshape(m.state_shape)
        res = m.engine.submit(
            RunPlan(target=m.target, n_steps=seg, init_words=w_flat[:size].reshape(m.state_shape),
                    key=key, step0=step0, collect=collect, **kwargs)
        ).result
        return (res.samples.reshape(-1, size), res.final_words.reshape(size),
                res.final_logp.to(torch.float32).reshape(size), res.accept_count.reshape(size))

    def block(words, logp, keys, step0s, layout, slots, *, seg, collect, every):
        n = words.shape[0]
        kept = seg if collect == "all" else 0
        outs = (torch.zeros((n, kept, n_pad), dtype=torch.int64, device=device),
                torch.zeros((n, n_pad), dtype=torch.int64, device=device),
                torch.zeros((n, n_pad), dtype=torch.float32, device=device),
                torch.zeros((n, n_pad), dtype=torch.int32, device=device))
        for s in range(n):
            for m in members:
                own = layout[s] == m.index
                if not (own or every):
                    continue
                with compiled.section((slots[s], m.index)) as recording:
                    got = branch(m, words[s], logp[s], keys[s], step0s[s], seg, collect)
                    if own or recording:
                        for out, x in zip(outs, got):
                            out[s, ..., :m.size].copy_(x)
        return outs

    block = _shard_over_chains(block, mesh, n_slots, device)

    def body(words, logp, keys, step0s, *, layout, every, seg, collect):
        samples, words_out, logp_out, acc = block(
            words, logp, keys, step0s, tuple(layout), tuple(range(n_slots)), seg=seg,
            collect=collect, every=every)
        words.copy_(words_out)
        logp.copy_(logp_out)
        return samples, acc

    return _compiled_advance(body, device, "scan class advance", n_carry=2, gated=True)


def _compiled_advance(body, device, what: str, n_carry: int = 1, gated: bool = False):
    """``body(*carries, *inputs, *, seg, collect) -> (samples, acc)``,
    which writes the segment's final state into its ``n_carry`` carry
    tensors, as an advance function ``advance(*carries, *inputs, *, seg,
    collect) -> (samples, *carries, acc)`` with one ``compiled.Program``
    a ``(seg, collect)`` in its ``programs``: JAX's jit with ``seg`` and
    ``collect`` static.  A program holds the carries it captured and
    stages the inputs (host or card tensors) into its buffers; on the
    card a failed capture or replay raises the ``RuntimeError`` naming
    the signature, and a carry other than the captured one raises too.
    ``advance.eager`` runs the body directly, outside any program: the
    twin a check compares a program with.

    ``gated``: the advance also takes the host ``layout`` (each slot's
    member, -1 for a free one) and hands the body ``layout`` and
    ``every``: True where a graph is captured (run every slot's every
    member, each a section), False where the body runs as it is (run each
    slot's own member).  A replay runs the sections ``(slot, member)`` of
    the layout."""
    programs: dict = {}

    def advance(*args, seg: int, collect: str, layout=None):
        carries, inputs = args[:n_carry], args[n_carry:]
        sig = (int(seg), collect)
        where = f"{what} (seg={sig[0]}, collect={collect!r})"
        held = programs.get(sig)
        if held is not None and held.graph is not None and any(
                a is not b for a, b in zip(held.holds, carries)):
            raise RuntimeError(
                f"{where}: the slot carry was replaced after the capture; the program "
                "reads and writes the one it captured")
        kw, enable = {}, None
        if gated:
            kw = dict(layout=layout, every=device.type == "cuda")
            enable = {(s, m) for s, m in enumerate(layout) if m >= 0}
        (samples, acc), _ = compiled.call(
            programs, sig, functools.partial(body, *carries, seg=sig[0], collect=collect, **kw),
            inputs, device, where, holds=carries, name="the packed segment", enable=enable)
        return (samples, *carries, acc)

    def eager(*args, seg: int, collect: str, layout=None):
        carries, inputs = args[:n_carry], args[n_carry:]
        kw = dict(layout=layout, every=False) if gated else {}
        samples, acc = body(*carries, *(x.to(device, non_blocking=True) for x in inputs),
                            seg=int(seg), collect=collect, **kw)
        return (samples, *carries, acc)

    advance.programs = programs
    advance.eager = eager
    return advance


def make_pallas_advance_fn(engine, target, state_shape: tuple):
    """The packed pallas segment: one kernel call over ALL slots a chunk.

    Returns ``advance(words, keys, step0s, *, seg, collect)`` ->
    ``(samples, words, accept)``, each with a leading slot axis and the
    member's shaped state.  The fold is the engine's chains-axis fold
    with slots in place of chains — slot-major into the MH column axis
    (site = i·C + c stays the solo site index) or the Gibbs lattice axis
    (i mod B stays the solo lattice index) — and the kernels take
    per-column / per-lattice key words and absolute-step bases as
    operands, so every slot advances on its solo stream in one launch.
    ``keys`` (S, 2) are the slots' stream keys: each request key already
    folded as ``engine.run`` folds it (``chain_key(key, 0)``, once at
    admission); ``step0s`` is the (S,) int64 tensor of their absolute
    steps.  Every slot runs, as under JAX's ``vmap``: host/cim randomness
    draws each slot's operands at its own offset, a free slot's under the
    dummy key at step 0, and a free slot's outputs reach no request.

    ``words`` is the carry: the final words are written back into it (the
    Gibbs kernels' int32 spins widened into the int64 carry) and it is
    returned as the new carry, while ``samples`` and ``accept`` are new
    tensors on every call, so a kept row outlives the next segment.  No
    logp carry crosses segments here: the caller derives a retiring
    slot's final log-prob from its words (``final_logp``) before the next
    segment overwrites them.  The Gibbs logit spec is taken once
    (``_fused_gibbs_logit``): a tempered lattice hands over its scaled
    spec.
    """
    backend = engine.randomness
    update = engine.config.update

    def operands(keys, step0s, seg, shape, nbits, need_flips):
        """Each slot's (flips, u) at its own offset: no host read of a
        step base, so the draw is captured with the kernel."""
        return [backend.chunk(keys[s], step0s[s], seg, shape, nbits, need_flips=need_flips)
                for s in range(keys.shape[0])]

    if update == "mh":
        nbits = target.nbits
        b, c = state_shape

        def body(words, keys, step0s, *, seg, collect):
            s = words.shape[0]
            state0 = words.permute(1, 0, 2).reshape(b, s * c)
            if backend.name == "fused":
                k0c, k1c = _fused_key_cols(keys, c)
                samples, acc = mh_ops.mh_sample_fused(
                    target.table, state0, k0c, k1c, n_steps=seg,
                    t0=step0s.repeat_interleave(c), nbits=nbits, p_bfr=backend.p_bfr, cc=c,
                )
            else:
                ops = operands(keys, step0s, seg, (b, c), nbits, True)
                samples, acc = mh_ops.mh_sample(
                    target.table, state0, _chains_fold_mh(torch.stack([f for f, _ in ops])),
                    _chains_fold_mh(torch.stack([u for _, u in ops])), nbits=nbits,
                )
            # (seg, b, s*c) -> (s, seg, b, c): slot-major columns
            samples = samples.reshape(seg, b, s, c).permute(2, 0, 1, 3)
            acc = acc.reshape(b, s, c).permute(1, 0, 2)
            words.copy_(samples[:, -1])
            return (samples if collect == "all" else samples[:, :0]), acc

    else:
        spec = _fused_gibbs_logit(target)
        b, h, w = state_shape

        def body(words, keys, step0s, *, seg, collect):
            s = words.shape[0]
            state0 = words.reshape(s * b, h, w)
            if backend.name == "fused":
                k0b, k1b = _fused_key_cols(keys, b)
                samples, acc = gibbs_ops.gibbs_sweep_fused(
                    state0, k0b, k1b, spec, n_steps=seg, t0=step0s.repeat_interleave(b),
                    lat_b=b,
                )
            else:
                us = [u for _, u in operands(keys, step0s, seg, (b, h, w), 1, False)]
                u = torch.stack(us, dim=1).reshape(seg, s * b, h, w)
                samples, acc = gibbs_ops.gibbs_sweep(
                    state0, u, spec, parity0=(step0s % 2).repeat_interleave(b),
                )
            # (seg, s*b, h, w) -> (s, seg, b, h, w): slot-major lattices
            samples = samples.reshape(seg, s, b, h, w).permute(1, 0, 2, 3, 4)
            acc = acc.reshape(s, b, h, w)
            words.copy_(samples[:, -1])  # int32 spins widened into the int64 carry
            return (samples if collect == "all" else samples[:, :0]), acc

    return _compiled_advance(body, engine.device, f"packed {update} advance")


def final_logp(engine, target, words: torch.Tensor) -> torch.Tensor:
    """A slot's final log-prob as its solo ``engine.run`` reports it: the
    table's log-prob under ``mh``, the per-site conditional log-prob
    (pseudo-likelihood) under ``gibbs``."""
    if engine.config.update == "gibbs":
        return _gibbs_logp(target, words)
    return target.log_prob(words).to(torch.float32)


class SegmentPipeline:
    """Run host finalize thunks at most ``depth`` segments behind the
    device.  ``push`` defers the thunk; once more than ``depth`` are
    pending the oldest runs (waiting for its own copies only then).
    ``drain`` flushes everything — call it when the serve loop idles or
    ends."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self._pending: deque = deque()

    def push(self, thunk) -> None:
        self._pending.append(thunk)
        while len(self._pending) > self.depth:
            # backpressure: the host is now > depth segments behind and
            # waits for the oldest segment's copies
            with telemetry.span("serving.pipeline_stall", pending=len(self._pending)):
                self._pending.popleft()()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft()()
