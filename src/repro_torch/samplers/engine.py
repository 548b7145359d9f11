"""The sampler engine — the PyTorch port of ``repro.samplers.engine``.

One chain datapath with the JAX package's axes and field names:

  * **target**      — ``CallableTarget`` / ``TableTarget`` / ``TopKTarget``
                      (MH), or a lattice model (Gibbs:
                      ``workloads.ising.IsingModel``,
                      ``workloads.spin_glass.SpinGlass``)
  * **update rule** — ``mh`` (XOR proposal, accept test) or ``gibbs``
                      (one checkerboard half-sweep per step, the flip
                      ``u < sigmoid(logit)``)
  * **randomness**  — ``host`` / ``cim`` / ``fused`` (randomness.py)
  * **execution**   — ``scan`` (a Python loop over steps in PyTorch) vs
                      ``pallas`` (the name is kept so one config builds
                      both engines: the CUDA kernels of ``csrc/mh.cu`` and
                      ``csrc/gibbs.cu`` for CUDA tensors, their plain
                      versions for CPU tensors); ``auto`` picks ``pallas``
                      for an MH table target on a CUDA device, else
                      ``scan`` — and always ``scan`` for Gibbs, as in JAX
  * **collection**  — ``all`` / ``thin:<k>`` (absolute steps
                      ``(step0 + t) % k == 0``) / ``last``

Both executors consume the same operands and the same update rule, so
with the same key they give identical sample streams; operands of step
``t`` depend only on ``(key, step0 + t)`` (and the Gibbs parity on
``step0 + t``), so chunking and ``step0`` segmentation never change the
stream.

Every entry runs on ``device`` — ``"cuda"`` unless the caller asks for
the CPU.  ``mesh`` (a 1-D ``torch.distributed`` ``DeviceMesh``, one
process per device) shards the chain axis under the "chains" rule: each
rank runs its slice of the chains on its own device and an all-gather
gives every rank the whole result, word for word the unsharded run's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.gibbs import ops as gibbs_ops
from repro_torch.kernels.gibbs.ref import sigmoid
from repro_torch.kernels.mh import ops as mh_ops
from repro_torch.kernels.mh.ref import accept_test
from repro_torch.samplers.randomness import (
    RandomnessBackend,
    chain_key,
    chain_keys,
    make_randomness_backend,
)
from repro_torch.samplers.targets import logits_target

_EXECUTION_CHOICES = ("auto", "scan", "pallas")
_UPDATE_CHOICES = ("mh", "gibbs")
_MASK32 = 0xFFFFFFFF


def parse_collect(collect: str) -> tuple[str, int]:
    """Validate a collection spec; returns ``(mode, k)``: ``"all"`` ->
    ("all", 1), ``"thin:<k>"`` -> ("thin", k) for k >= 1, ``"last"`` ->
    ("last", 0)."""
    if collect == "all":
        return ("all", 1)
    if collect == "last":
        return ("last", 0)
    if isinstance(collect, str) and collect.startswith("thin:"):
        try:
            k = int(collect[len("thin:"):])
        except ValueError:
            k = 0
        if k >= 1:
            return ("thin", k)
    raise ValueError(
        f"collect must be 'all', 'last' or 'thin:<k>' (k >= 1), got {collect!r}"
    )


def kept_count(n_steps: int, k: int, step0: int = 0) -> int:
    """Size of the ``thin:k`` kept set {t in [0, n_steps):
    (step0 + t) % k == 0}."""
    if k < 1:
        raise ValueError(f"thin stride k must be >= 1, got {k}")
    i0 = (-int(step0)) % k
    return 0 if i0 >= n_steps else (n_steps - i0 - 1) // k + 1


def _thin_offset(step0: int, k: int) -> int:
    """First kept relative step of a span starting at absolute ``step0``."""
    return (-int(step0)) % k


def _effective_chunk(n_steps: int, chunk: int, thin_k: int | None) -> int:
    """The chunk-schedule rule of every executor: clamp to [1, n_steps],
    and under ``thin:k`` align to a multiple of k."""
    chunk = max(1, min(chunk, n_steps))
    if thin_k is not None and thin_k > 1:
        chunk = thin_k * max(1, chunk // thin_k)
    return chunk


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the engine's axes — the JAX package's field
    names and values, so one dict builds both engines.  ``block_c`` is the
    TPU kernel's lane block; the CUDA kernels pick their own blocks and
    ignore it."""

    p_bfr: float = 0.45              # proposal bit-flip rate (pseudo-read)
    randomness: str = "cim"          # host | cim | fused
    rng_p_bfr: float | None = None   # [0,1]-RNG raw-bit bias (default p_bfr)
    rng_bit_width: int = 16          # u precision (cim backend)
    rng_stages: int = 3              # MSXOR stages (cim backend)
    update: str = "mh"               # mh | gibbs
    execution: str = "auto"          # auto | scan | pallas
    chunk_steps: int = 64            # randomness streaming granularity
    block_c: int = 256               # TPU lane block (unused by the port)
    num_chains: int = 1              # independent chains
    collect: str = "all"             # all | thin:<k> | last

    def __post_init__(self):
        if self.execution not in _EXECUTION_CHOICES:
            raise ValueError(
                f"execution must be one of {_EXECUTION_CHOICES}, "
                f"got {self.execution!r}"
            )
        if self.update not in _UPDATE_CHOICES:
            raise ValueError(
                f"update must be one of {_UPDATE_CHOICES}, got {self.update!r}"
            )
        if self.randomness not in ("host", "cim", "fused"):
            raise ValueError(
                f"randomness must be host|cim|fused, got {self.randomness!r}"
            )
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {self.chunk_steps}")
        if self.block_c < 1:
            raise ValueError(f"block_c must be >= 1, got {self.block_c}")
        if self.rng_bit_width < 1:
            raise ValueError(f"rng_bit_width must be >= 1, got {self.rng_bit_width}")
        if self.rng_stages < 1:
            raise ValueError(f"rng_stages must be >= 1, got {self.rng_stages}")
        if self.num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {self.num_chains}")
        parse_collect(self.collect)

    def backend(self) -> RandomnessBackend:
        return make_randomness_backend(
            self.randomness,
            p_bfr=self.p_bfr,
            rng_p_bfr=self.rng_p_bfr,
            rng_bit_width=self.rng_bit_width,
            rng_stages=self.rng_stages,
        )


class EngineResult(NamedTuple):
    samples: torch.Tensor          # (K_kept, *chain_shape) uint32 words as int64
    accept_count: torch.Tensor     # (*chain_shape,) int32
    acceptance_rate: torch.Tensor  # scalar float32
    final_words: torch.Tensor      # (*chain_shape,) uint32 words as int64
    final_logp: torch.Tensor       # (*chain_shape,) float32
    n_steps: int                   # total steps run (not kept)


def resolve_execution(execution: str, target, device, update: str = "mh") -> str:
    """Executor dispatch: an explicit choice wins; ``auto`` runs the fused
    MH kernel for a table target on a CUDA device, scan elsewhere.

    ``gibbs`` keeps the JAX package's rule: ``pallas`` needs a lattice
    model the checkerboard kernel knows (``supports_fused_gibbs``), and
    ``auto`` is always ``scan``."""
    if update == "gibbs":
        if execution == "pallas":
            if not getattr(target, "supports_fused_gibbs", False):
                raise ValueError(
                    "pallas Gibbs execution needs a lattice model with a "
                    "fused checkerboard kernel (supports_fused_gibbs); "
                    "use execution='scan'"
                )
            return "pallas"
        return "scan"
    if execution == "pallas":
        if target.table is None:
            raise ValueError(
                "pallas execution needs a table target (the fused kernel "
                "holds the distribution); use a TableTarget or "
                "execution='scan'"
            )
        return "pallas"
    if execution == "scan":
        return "scan"
    if target.table is not None and torch.device(device).type == "cuda":
        return "pallas"
    return "scan"


def _mh_step(target, nbits: int, words, logp, acc, flip, u):
    """THE scan-side MH step: XOR-propose, lookup, accept test, select —
    the kernels' step, op for op."""
    cand = words ^ (flip & ((1 << nbits) - 1))
    logp_cand = target.log_prob(cand).to(torch.float32)
    accept = accept_test(u, logp_cand, logp)
    words = torch.where(accept, cand, words)
    logp = torch.where(accept, logp_cand, logp)
    return words, logp, acc + accept.to(torch.int32)


def _n_keep(n_steps: int, step0: int, collect: tuple[str, int]) -> int:
    mode, k = collect
    if mode == "all":
        return n_steps
    if mode == "thin":
        return kept_count(n_steps, k, step0)
    return 0


def _run_scan_chunked(make_xs, step_fn, carry, n_steps, chunk, step0, collect):
    """The scan executor's chunk loop: ``make_xs(start, n)`` draws the
    operands of absolute steps [start, start + n); ``step_fn`` advances
    one step with ``carry[0]`` the chain state.  Kept states are written
    into one preallocated buffer."""
    mode, k = collect
    chunk = _effective_chunk(n_steps, chunk, k if mode == "thin" else None)
    state = carry[0]
    out = torch.empty(
        (_n_keep(n_steps, step0, collect), *state.shape), dtype=torch.int64,
        device=state.device,
    )
    pos = 0
    for start in range(0, n_steps, chunk):
        n = min(chunk, n_steps - start)
        xs = make_xs(step0 + start, n)
        for t in range(n):
            carry = step_fn(carry, tuple(x[t] for x in xs))
            if mode == "all" or (mode == "thin" and (step0 + start + t) % k == 0):
                out[pos] = carry[0]
                pos += 1
    return out, carry


def _run_scan(
    key, target, backend, nbits, n_steps, chunk, step0, init_words, collect,
    init_logp=None,
):
    shape = tuple(init_words.shape)
    logp0 = target.log_prob(init_words) if init_logp is None else init_logp
    carry = (
        init_words,
        logp0.to(torch.float32),
        torch.zeros(shape, dtype=torch.int32, device=init_words.device),
    )

    def make_xs(start, n):
        return backend.chunk(key, start, n, shape, nbits)

    def step_fn(c, x):
        return _mh_step(target, nbits, *c, *x)

    samples, (words, logp, acc) = _run_scan_chunked(
        make_xs, step_fn, carry, n_steps, chunk, step0, collect
    )
    return samples, acc, words, logp


def _drive_pallas_chunks(run_chunk, init_state, n_steps, chunk, step0, collect):
    """The kernel executors' chunk loop: ``run_chunk(state, start, n)``
    launches one kernel for relative steps [start, start + n) and returns
    (samples (n, *state shape), per-chain accept counts).  Kept rows go
    straight into one preallocated int64 buffer (widened there: the Gibbs
    kernels write int32 spins); under "last" only (state, count) survive
    a chunk."""
    mode, k = collect
    chunk = _effective_chunk(n_steps, chunk, k if mode == "thin" else None)
    state = init_state
    acc = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    out = torch.empty(
        (_n_keep(n_steps, step0, collect), *state.shape), dtype=torch.int64,
        device=state.device,
    )
    pos = 0
    for start in range(0, n_steps, chunk):
        n = min(chunk, n_steps - start)
        samples, a = run_chunk(state, start, n)
        state = samples[-1]
        acc += a
        if mode == "all":
            rows = samples
        elif mode == "thin":
            rows = samples[_thin_offset(step0 + start, k)::k]
        else:
            continue
        out[pos:pos + rows.shape[0]] = rows
        pos += rows.shape[0]
    return out, acc, state


def _fused_key_cols(keys: torch.Tensor, repeat: int):
    """Per-column key words for the fused kernel: each chain key's two
    words repeated over its ``repeat`` columns, chain-major.  ``keys`` is
    one (2,) key or a (C, 2) stack."""
    keys = keys.reshape(-1, 2)
    return (
        keys[:, 0].repeat_interleave(repeat),
        keys[:, 1].repeat_interleave(repeat),
    )


def _run_pallas(key, target, backend, nbits, n_steps, chunk, step0, init_words, collect):
    if init_words.ndim != 2:
        raise ValueError(
            f"pallas execution expects (B, C) chain state, got {tuple(init_words.shape)}"
        )
    if backend.name == "fused":
        c = init_words.shape[1]
        k0c, k1c = _fused_key_cols(key, c)

        def run_chunk(state, start, n):
            return mh_ops.mh_sample_fused(
                target.table, state, k0c, k1c, n_steps=n, t0=step0 + start,
                nbits=nbits, p_bfr=backend.p_bfr, cc=c,
            )
    else:

        def run_chunk(state, start, n):
            flips, u = backend.chunk(key, step0 + start, n, tuple(state.shape), nbits)
            return mh_ops.mh_sample(target.table, state, flips, u, nbits=nbits)

    samples, acc, state = _drive_pallas_chunks(
        run_chunk, init_words, n_steps, chunk, step0, collect
    )
    logp = target.log_prob(state).to(torch.float32)
    return samples, acc, state, logp


def _chains_fold_mh(x: torch.Tensor) -> torch.Tensor:
    """(C, K, B, Cc) operands -> (K, B, C*Cc): chains ride the column
    axis, chain-major, so chain c owns columns [c*Cc, (c+1)*Cc)."""
    c, k, b, cc = x.shape
    return x.permute(1, 2, 0, 3).reshape(k, b, c * cc)


def _run_pallas_chains(
    keys, target, backend, nbits, n_steps, chunk, step0, init, collect
):
    """The fused kernel over C chains: one launch per chunk, chains folded
    into the column axis."""
    if init.ndim != 3:
        raise ValueError(
            f"multi-chain pallas execution expects (num_chains, B, C) chain "
            f"state, got {tuple(init.shape)}"
        )
    c_chains, b, cc = init.shape
    state0 = init.permute(1, 0, 2).reshape(b, c_chains * cc)

    if backend.name == "fused":
        k0c, k1c = _fused_key_cols(keys, cc)

        def run_chunk(state, start, n):
            return mh_ops.mh_sample_fused(
                target.table, state, k0c, k1c, n_steps=n, t0=step0 + start,
                nbits=nbits, p_bfr=backend.p_bfr, cc=cc,
            )
    else:

        def run_chunk(state, start, n):
            ops = [backend.chunk(k, step0 + start, n, (b, cc), nbits) for k in keys]
            flips = torch.stack([f for f, _ in ops])
            u = torch.stack([u for _, u in ops])
            return mh_ops.mh_sample(
                target.table, state, _chains_fold_mh(flips), _chains_fold_mh(u),
                nbits=nbits,
            )

    samples, acc, state = _drive_pallas_chunks(
        run_chunk, state0, n_steps, chunk, step0, collect
    )

    def unfold(x):  # (..., B, C*Cc) -> (C, ..., B, Cc)
        lead = x.shape[:-2]
        return torch.movedim(x.reshape(*lead, b, c_chains, cc), -2, 0)

    logp = target.log_prob(state).to(torch.float32)
    return unfold(samples), unfold(acc), unfold(state), unfold(logp)


def _gibbs_step(target, state, acc, u, parity: int):
    """THE scan-side Gibbs half-sweep — the kernels' half-sweep, op for
    op: conditional logit from the current neighbours, the new value
    ``u < sigmoid(logit)`` written on the active checkerboard colour only.
    ``acc`` counts sites whose value changed (the flip count)."""
    new = (u < sigmoid(target.conditional_logit(state))).to(torch.int64)
    active = target.update_mask(tuple(state.shape), parity, device=state.device)
    nxt = torch.where(active, new, state)
    return nxt, acc + (nxt != state).to(torch.int32)


def _run_scan_gibbs(key, target, backend, n_steps, chunk, step0, init_words, collect):
    shape = tuple(init_words.shape)
    carry = (init_words, torch.zeros(shape, dtype=torch.int32, device=init_words.device))

    def make_xs(start, n):
        # the half-sweep parity of absolute step start + t: a card tensor
        # when ``start`` is one
        _, u = backend.chunk(key, start, n, shape, 1, need_flips=False)
        return u, [start + t for t in range(n)]

    def step_fn(c, x):
        u_t, t = x
        return _gibbs_step(target, *c, u_t, t % 2)

    samples, (state, acc) = _run_scan_chunked(
        make_xs, step_fn, carry, n_steps, chunk, step0, collect
    )
    return samples, acc, state


def _fused_gibbs_logit(target):
    """The logit spec the Gibbs kernels take (``IsingLogit`` or
    ``SpinGlassLogit``): the kernel cannot trace a closure, so a lattice
    model hands over its conditional in that form."""
    spec = getattr(target, "logit_spec", None)
    if spec is None:
        raise ValueError(
            f"{type(target).__name__} has no logit_spec: the Gibbs kernels know "
            "the Ising and spin-glass conditionals only; use execution='scan'"
        )
    return spec


def _run_pallas_gibbs(key, target, backend, n_steps, chunk, step0, init_words, collect):
    """The Gibbs kernels on one chain: the C-chain executor with C = 1."""
    if init_words.ndim != 3:
        raise ValueError(
            f"pallas Gibbs expects (B, H, W) lattice state, got "
            f"{tuple(init_words.shape)}"
        )
    samples, acc, words = _run_pallas_gibbs_chains(
        key[None], target, backend, n_steps, chunk, step0, init_words[None], collect
    )
    return samples[0], acc[0], words[0]


def _run_pallas_gibbs_chains(keys, target, backend, n_steps, chunk, step0, init, collect):
    """The Gibbs kernels over C chains: one call per chunk, chains folded
    into the lattice-batch axis chain-major (lattice c * B + i).  Each
    chunk's int32 state is the next chunk's init."""
    if init.ndim != 4:
        raise ValueError(
            f"multi-chain pallas Gibbs expects (num_chains, B, H, W) lattice "
            f"state, got {tuple(init.shape)}"
        )
    logit = _fused_gibbs_logit(target)
    c_chains, b, h, w = init.shape
    state0 = init.reshape(c_chains * b, h, w)
    if backend.name == "fused":
        k0b, k1b = _fused_key_cols(keys, b)

        def run_chunk(state, start, n):
            return gibbs_ops.gibbs_sweep_fused(
                state, k0b, k1b, logit, n_steps=n, t0=step0 + start, lat_b=b,
            )
    else:

        def run_chunk(state, start, n):
            us = [backend.chunk(k, step0 + start, n, (b, h, w), 1, need_flips=False)[1]
                  for k in keys]  # C blocks of (n, B, H, W)
            # one chain's block goes to the kernel as it is; C > 1 are
            # interleaved chain-major into the lattice axis (one copy)
            u = us[0] if c_chains == 1 else (
                torch.stack(us, dim=1).reshape(n, c_chains * b, h, w))
            return gibbs_ops.gibbs_sweep(state, u, logit, parity0=(step0 + start) % 2)

    samples, acc, state = _drive_pallas_chunks(
        run_chunk, state0, n_steps, chunk, step0, collect
    )

    def unfold(x):  # (..., C*B, H, W) -> (C, ..., B, H, W)
        lead = x.shape[:-3]
        return torch.movedim(x.reshape(*lead, c_chains, b, h, w), len(lead), 0)

    # the kernels' spins are int32; the kept rows were widened as they were
    # copied out, and the final words are widened here
    return unfold(samples), unfold(acc), unfold(state.to(torch.int64))


def _gather_chains(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """Every rank's (C/n, ...) block, concatenated along the chain axis in
    rank order.  An empty block (``collect="last"``'s samples) needs no
    collective."""
    import torch.distributed as dist

    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    if x.numel():
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=group)
    return out


def _shard_over_chains(body, mesh, num_chains: int, device: torch.device):
    """Wrap ``body(*args, **kw)`` so each rank of ``mesh`` runs its slice
    of the chains and all ranks get the whole result: every positional
    argument (a tensor or a list) holds one entry per chain on its leading
    axis and is sliced to the rank's contiguous block; keywords pass as
    they are, and each returned tensor is all-gathered along its leading
    axis.  The serving tier shards its slot axis through the same wrap.

    The "chains" axis resolves through ``distributed.sharding.spec_for``
    with its divisibility filter: a chain count the mesh does not divide
    runs replicated (every rank runs every chain), and no mesh is the
    identity.  Chains never communicate, so the sharded run equals the
    unsharded one word for word (the JAX package's ``shard_map``)."""
    from repro_torch.distributed import sharding

    if mesh is None:
        return body
    spec = sharding.spec_for(("chains",), shape=(num_chains,), mesh=mesh)
    if not spec or spec[0] is None:
        return body
    if mesh.ndim != 1 or not isinstance(spec[0], str):
        raise ValueError(
            f"the chains axis shards over a 1-D mesh, got dimensions "
            f"{mesh.mesh_dim_names}"
        )
    if mesh.device_type != device.type:
        raise ValueError(
            f"a {mesh.device_type} mesh cannot shard an engine on {device}: "
            "build the mesh on the engine's device type"
        )
    n = mesh.size()
    rank = mesh.get_local_rank(spec[0])
    group = mesh.get_group(spec[0])
    per = num_chains // n

    def sharded(*args, **kw):
        lo = rank * per
        outs = body(*(a[lo:lo + per] for a in args), **kw)
        return tuple(_gather_chains(x, n, group) for x in outs)

    return sharded


def _gibbs_logp(target, words: torch.Tensor) -> torch.Tensor:
    """Per-site conditional log-prob (pseudo-likelihood) of ``words``."""
    logit = target.conditional_logit(words)
    logsig = torch.nn.functional.logsigmoid
    return torch.where(words == 1, logsig(logit), logsig(-logit)).to(torch.float32)


def _acceptance_rate(acc: torch.Tensor, n_steps: int) -> torch.Tensor:
    total = np.float32(n_steps) * np.float32(max(1, acc.numel()))
    return acc.sum().to(torch.float32) / torch.full(
        (), float(total), dtype=torch.float32, device=acc.device
    )


def resolve_device(device) -> torch.device:
    """The port's device rule: ``None`` means the current CUDA card, and
    a missing card raises; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless asked otherwise, and "
                "no CUDA device is available; pass device='cpu' to run the "
                "plain versions on the CPU"
            )
        if dev.index is None:  # "cuda" names the current card: pin its index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _wait(device: torch.device) -> None:
    """End a timed region: the card's queue drained, so a wall clock
    times the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MHEngine:
    """The sampler engine on one device, ``mh`` or ``gibbs`` update rule
    (``SamplerEngine`` aliases it).

    ``device`` defaults to ``"cuda"``; the engine raises if there is no
    card and never moves to the CPU on its own.  Keys, init words and
    init log-probs are moved to the engine's device; a table target or a
    spin glass's couplings must already live there.
    """

    def __init__(self, config: EngineConfig = EngineConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self._backend = config.backend()
        # submit(compiled=True)'s programs by signature (samplers/plan.py):
        # they live and die with the engine
        self._compiled = {}

    @property
    def randomness(self) -> RandomnessBackend:
        return self._backend

    def submit(self, plan, *, compiled: bool = False):
        """Run a validated ``RunPlan``; returns a re-submittable
        ``RunHandle`` — the documented public entry.  ``compiled=True``
        captures the run as a CUDA graph once per signature and replays it
        after that (``samplers/plan.py``)."""
        from repro_torch.samplers.plan import submit  # plan imports engine

        return submit(self, plan, compiled=compiled)

    def _key(self, key) -> torch.Tensor:
        return torch.as_tensor(key).to(device=self.device, dtype=torch.int64) & _MASK32

    def _words(self, words) -> torch.Tensor:
        if not isinstance(words, torch.Tensor):
            words = torch.from_numpy(np.asarray(words).astype(np.int64))
        return words.to(device=self.device, dtype=torch.int64) & _MASK32

    def _step0(self, step0, collect: tuple[str, int]):
        """An int ``step0`` checked, or a tensor one as a 0-d int64 tensor
        on the engine's device, never read on the host."""
        if not isinstance(step0, torch.Tensor):
            step0 = int(step0)
            if step0 < 0:
                raise ValueError(f"step0 must be >= 0, got {step0}")
            return step0
        if step0.ndim != 0:
            raise ValueError(f"a tensor step0 is 0-d, got shape {tuple(step0.shape)}")
        if collect[0] == "thin":
            raise ValueError(
                "collect='thin:<k>' needs an int step0: the kept count is a "
                "shape, and a tensor step0 is not read on the host"
            )
        return step0.to(device=self.device, dtype=torch.int64)

    def _check_target(self, target) -> None:
        for name in ("table", "j_right", "j_down"):
            x = getattr(target, name, None)
            if isinstance(x, torch.Tensor) and x.device != self.device:
                raise ValueError(
                    f"the target's {name} is on {x.device}, the engine on "
                    f"{self.device}: build the target on the engine's device"
                )
        if self.config.update == "gibbs" and not hasattr(target, "conditional_logit"):
            raise ValueError(
                "gibbs update needs a conditional target exposing "
                "conditional_logit/update_mask (e.g. workloads.ising."
                f"IsingModel); got {type(target).__name__}"
            )

    def run(
        self, key, target, n_steps: int, init_words, *,
        chain_id: int = 0, mesh=None, step0=0, collect: str | None = None,
        init_logp=None,
    ) -> EngineResult:
        """Run ``n_steps`` steps of the configured update rule from
        ``init_words``; keep what ``collect`` says (default:
        ``config.collect``).

        ``mh``: ``init_words`` is (B, C) for a table target (B targets x C
        chains) and any shape for a callable target.  ``gibbs``: it is the
        lattice state (..., H, W) of {0, 1} words, strictly (B, H, W)
        under pallas execution; each step is one checkerboard half-sweep,
        ``accept_count`` is the per-site flip count and ``final_logp`` the
        per-site conditional log-prob of the final state.  With
        ``config.num_chains == C > 1`` it carries a leading (C,) axis and
        every result field gains it — chain c is bit-identical to a solo
        run with ``chain_id=chain_id + c``.  ``step0`` offsets the
        randomness stream (and the Gibbs checkerboard parity) by an
        absolute step count, so a run resumed from ``(final_words,
        step0=s)`` continues one unsegmented run exactly.  ``init_logp``
        (solo MH scan only) seeds the carried log-prob.
        ``step0`` may be a 0-d int64 tensor on the engine's device (JAX's
        traced offset): every executor takes it as an operand and never
        reads it on the host, so the run can be captured and replayed at
        other steps.  ``"thin:<k>"`` needs an int ``step0``: its kept
        count is a shape.
        ``mesh`` (a 1-D ``DeviceMesh``) shards the chain axis of a C-chain
        run across its ranks (``_shard_over_chains``); a solo run ignores
        it, as in the JAX package.
        """
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        collect = parse_collect(self.config.collect if collect is None else collect)
        step0 = self._step0(step0, collect)
        if init_logp is not None and (
            self.config.num_chains > 1 or self.config.update == "gibbs"
        ):
            raise ValueError(
                "init_logp resumes the solo MH carry only — the Gibbs carry "
                "holds no log-prob and the chains axis derives its own "
                "per-chain carries"
            )
        self._check_target(target)
        key = self._key(key)
        init = self._words(init_words)
        if self.config.num_chains > 1:
            return self._run_chains(
                key, target, n_steps, init, mesh, base=chain_id, step0=step0,
                collect=collect,
            )
        key = chain_key(key, chain_id)
        if self.config.update == "gibbs":
            return self._run_gibbs(key, target, n_steps, init, step0, collect)
        execution = resolve_execution(self.config.execution, target, self.device)
        args = (key, target, self._backend, target.nbits, n_steps,
                self.config.chunk_steps, step0, init, collect)
        if execution == "scan":
            if init_logp is not None:
                init_logp = torch.as_tensor(init_logp).to(self.device)
            samples, acc, words, logp = _run_scan(*args, init_logp)
        else:
            if init_logp is not None:
                raise ValueError(
                    "init_logp needs scan execution — the MH kernel re-derives "
                    "the table log-prob from the state words"
                )
            samples, acc, words, logp = _run_pallas(*args)
        return EngineResult(
            samples=samples,
            accept_count=acc,
            acceptance_rate=_acceptance_rate(acc, n_steps),
            final_words=words,
            final_logp=logp,
            n_steps=n_steps,
        )

    def _run_gibbs(self, key, target, n_steps: int, init, step0: int, collect):
        execution = resolve_execution(
            self.config.execution, target, self.device, "gibbs"
        )
        run = _run_scan_gibbs if execution == "scan" else _run_pallas_gibbs
        samples, acc, words = run(
            key, target, self._backend, n_steps, self.config.chunk_steps, step0,
            init, collect,
        )
        return EngineResult(
            samples=samples,
            accept_count=acc,
            acceptance_rate=_acceptance_rate(acc, n_steps),
            final_words=words,
            final_logp=_gibbs_logp(target, words),
            n_steps=n_steps,
        )

    def _run_chains(
        self, key, target, n_steps: int, init, mesh=None, base: int = 0, step0: int = 0,
        collect: tuple[str, int] = ("all", 1),
    ) -> EngineResult:
        """C independent chains; ``base`` offsets the chain ids, so two
        C-chain runs with bases 0 and C compose into the 2C-chain run.
        ``mesh`` shards them across ranks (``_shard_over_chains``)."""
        cfg = self.config
        num_chains = cfg.num_chains
        # the leading axis is ALWAYS the chain axis — never guessed
        if init.ndim == 0 or init.shape[0] != num_chains:
            raise ValueError(
                f"multi-chain init_words must carry a leading "
                f"(num_chains={num_chains},) axis, got {tuple(init.shape)}; "
                f"broadcast a solo init with init.expand({num_chains}, *init.shape)"
            )
        keys = chain_keys(key, num_chains, base=base)
        if cfg.update == "gibbs":
            execution = resolve_execution(cfg.execution, target, self.device, "gibbs")
            args = (target, self._backend, n_steps, cfg.chunk_steps, step0)

            def body(ks, ini):
                if execution == "pallas":
                    return _run_pallas_gibbs_chains(ks, *args, ini, collect)
                runs = [_run_scan_gibbs(k, *args, w, collect) for k, w in zip(ks, ini)]
                return tuple(torch.stack(x) for x in zip(*runs))

            body = _shard_over_chains(body, mesh, num_chains, self.device)
            samples, acc, words = body(keys, init)
            logp = _gibbs_logp(target, words)
        else:
            execution = resolve_execution(cfg.execution, target, self.device)
            args = (target, self._backend, target.nbits, n_steps, cfg.chunk_steps, step0)

            def body(ks, ini):
                if execution == "pallas":
                    return _run_pallas_chains(ks, *args, ini, collect)
                runs = [_run_scan(k, *args, w, collect) for k, w in zip(ks, ini)]
                return tuple(torch.stack(x) for x in zip(*runs))

            body = _shard_over_chains(body, mesh, num_chains, self.device)
            samples, acc, words, logp = body(keys, init)
        return EngineResult(
            samples=samples,
            accept_count=acc,
            acceptance_rate=_acceptance_rate(acc, n_steps),
            final_words=words,
            final_logp=logp,
            n_steps=n_steps,
        )

    def sample_tokens(
        self,
        key,
        logits,
        n_steps: int,
        temperature: float = 1.0,
        top_k: int = 0,
        init_tokens=None,
    ) -> tuple[torch.Tensor, EngineResult]:
        """Draw one token per row of ``logits`` (B, V): one chain per row.

        Returns (tokens (B,) int32, full EngineResult).  ``init_tokens``
        seeds the chains; the default is the row argmax.
        """
        target = logits_target(logits, temperature=temperature, top_k=top_k)
        if init_tokens is None:
            init = torch.argmax(target.table, dim=-1)
        else:
            init = torch.clamp(
                self._words(init_tokens), 0, target.table.shape[-1] - 1
            )
        result = self.run(key, target, n_steps, init[:, None])
        tokens = target.decode(result.final_words)[:, 0].to(torch.int32)
        return tokens, result


SamplerEngine = MHEngine


def run_engine(
    key, init_words, *, engine: MHEngine, target, n_steps: int,
    chain_id: int = 0, step0: int = 0, collect: str | None = None,
):
    """Deprecated entry — build a ``RunPlan`` and call
    ``engine.submit(plan, compiled=True)`` instead.  Warns on every call
    and returns that submit's result, the same stream."""
    import warnings

    from repro_torch.samplers.plan import RunPlan, submit

    warnings.warn(
        "run_engine is deprecated; build a samplers.RunPlan and call "
        "engine.submit(plan, compiled=True)",
        DeprecationWarning,
        stacklevel=2,
    )
    plan = RunPlan(
        target=target, n_steps=n_steps, init_words=init_words, key=key,
        chain_id=chain_id, step0=step0, collect=collect,
    )
    return submit(engine, plan, compiled=True).result
