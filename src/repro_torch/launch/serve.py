"""Slot-based batched serving with CIM-MCMC token sampling — the port of
``repro.launch.serve``.

A fixed pool of ``--slots`` decode slots shares one KV cache; requests
join free slots (their prompt is prefilled into the slot's cache rows),
decode steps advance *all* slots in lock-step, finished slots free up
and are refilled from a FIFO overflow queue (``--requests`` may exceed
the pool).  The decode index is per-row, so slots hold prompts of
different lengths.  Tokens are drawn by the paper's MCMC sampler
(softmax-free, the default), by categorical sampling or greedily.

``--backend`` selects the MCMC executor: ``scan`` runs the torch chain,
``pallas`` the MH chain kernel (``csrc/mh.cu``; its plain version on
the CPU), ``auto`` the kernel on the card and scan on the CPU.  The
server runs on the card unless ``--device cpu`` is asked for.  The
sampling key stream is the JAX server's: ``fold_in(PRNGKey(seed), 1)``,
split once for every sample.  The weights are drawn from a
``torch.Generator`` seeded with ``--seed`` (``models/layers.py``), not
JAX's, so the two servers' streams agree when the weights are carried
across (``repro_torch.convert.lm_from_numpy``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite3_8b --smoke \\
      --requests 8 --prompt-len 12 --gen 16 --sampler mcmc --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, prng
from repro_torch.core import token_sampler
from repro_torch.models import lm
from repro_torch.samplers.engine import _wait, resolve_device
from repro_torch.samplers.targets import _divide
from repro_torch.serving import FIFOQueue


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 4
    max_len: int = 128
    gen_tokens: int = 16
    sampler: str = "mcmc"            # mcmc | categorical | greedy
    backend: str = "auto"            # auto | scan | pallas (MCMC execution)
    mcmc_steps: int = 32
    temperature: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    out_tokens: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0


class BatchedServer:
    """One model, n_slots concurrent sequences, lock-step decode, on
    ``device`` (the card unless ``"cpu"`` is asked for).  ``model`` is the
    ``lm.LM`` it serves; assign another of the same config (or load its
    state) to serve other weights.  Admission and decode run under
    ``torch.inference_mode``; the tensors they make are inference tensors."""

    def __init__(self, cfg, serve_cfg: ServeConfig, device=None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = resolve_device(device)
        self.model = lm.init_lm(cfg, serve_cfg.seed, self.device)
        self.key = prng.fold_in(prng.PRNGKey(serve_cfg.seed, device=self.device), 1)
        self.sampler_cfg = token_sampler.TokenSamplerConfig(
            vocab_size=cfg.vocab_size,
            n_steps=serve_cfg.mcmc_steps,
            temperature=serve_cfg.temperature,
            execution=serve_cfg.backend,
        )
        # slot state; the decode index is per-row (B,) so slots sit at
        # their own positions — heterogeneous prompt lengths pack safely
        # (cache contract: models/lm.py)
        n = serve_cfg.n_slots
        self.cache = lm.init_cache(cfg, n, serve_cfg.max_len, self.device)
        self.cache["index"] = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self.slot_req: list[Request | None] = [None] * n
        self.slot_remaining = np.zeros(n, dtype=int)
        self.last_tokens = torch.zeros((n, 1), dtype=torch.int32, device=self.device)
        self.acceptance: list[float] = []

    # --- request admission ----------------------------------------------------

    def _prefill_slot(self, slot: int, req: Request):
        """Per-slot prefill: the prompt runs through the stack as a
        single-row batch into a fresh row cache, which replaces the
        shared cache's row ``slot``; returns the prompt's last logits."""
        cfg = self.cfg
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.device)[None, :]
        row_cache = lm.init_cache(cfg, 1, self.scfg.max_len, self.device)
        logits, row_cache = lm.prefill(self.model, cfg, {"tokens": prompt}, row_cache)
        # splice the prefilled row into the shared slot cache, leaf by
        # leaf (a KV cache, an SSM state, or the hybrid's nested pair)
        def splice(shared, row):
            shared[:, slot:slot + 1] = row

        lm.tree_map(splice, self.cache["layers"], row_cache["layers"])
        # only this slot's decode position moves — other slots keep
        # decoding at their own indices mid-flight
        self.cache["index"][slot] = row_cache["index"]
        return logits[0]

    @torch.inference_mode()
    def submit(self, slot: int, req: Request):
        req.t_submit = time.time()
        logits = self._prefill_slot(slot, req)
        self.slot_req[slot] = req
        self.slot_remaining[slot] = self.scfg.gen_tokens
        first = self._sample(logits[None, :])[0]
        req.out_tokens.append(int(first))
        self.last_tokens[slot, 0] = first

    # --- sampling ---------------------------------------------------------------

    def _sample(self, logits):
        keys = prng.split(self.key)
        self.key, sub = keys[0], keys[1]
        v = self.cfg.vocab_size
        if self.scfg.sampler == "greedy":
            return torch.argmax(logits[:, :v], dim=-1).to(torch.int32)
        if self.scfg.sampler == "categorical":
            scaled = _divide(logits[:, :v], self.scfg.temperature)
            return prng.categorical(sub, scaled).to(torch.int32)
        result = token_sampler._sample_tokens_impl(sub, logits[:, :v], self.sampler_cfg)
        self.acceptance.append(float(result.acceptance_rate))
        return result.tokens

    # --- decode loop ------------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One lock-step decode across all slots, idle ones too; finished
        requests free their slot and are returned (continuous batching:
        the caller refills freed slots from its overflow queue)."""
        logits, self.cache = lm.decode_step(self.model, self.cfg, self.last_tokens, self.cache)
        tokens = self._sample(logits)
        host = tokens.tolist()
        done = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.out_tokens.append(host[slot])
            self.slot_remaining[slot] -= 1
            if self.slot_remaining[slot] == 0:
                req.t_done = time.time()
                self.slot_req[slot] = None
                done.append(req)
        self.last_tokens = tokens[:, None]
        return done

    def free_slot(self) -> int | None:
        """Lowest free slot index, or None when the pool is full."""
        for slot, req in enumerate(self.slot_req):
            if req is None:
                return slot
        return None

    def active(self) -> int:
        return sum(req is not None for req in self.slot_req)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Batched LLM serving with CIM-MCMC token sampling (PyTorch port).",
    )
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument(
        "--slots", type=int, default=None,
        help="decode slot pool size (default min(requests, 4)); overflow "
        "requests wait in a FIFO and join as slots free up",
    )
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sampler", default="mcmc", choices=["mcmc", "categorical", "greedy"])
    ap.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "scan", "pallas"],
        help="MCMC execution: the torch chain (scan), the MH chain kernel "
        "(pallas; its plain version on the CPU), or auto (the kernel on "
        "the card, scan on the CPU)",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the server runs: the card (default; raises without one) "
        "or the CPU",
    )
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve ``--requests`` prompts; prints the JAX server's ``[serve]``
    lines and returns the summary they print."""
    args = parse_args(argv)
    cfg = (
        configs.get_smoke_config(args.arch)
        if args.smoke
        else configs.get_config(args.arch)
    )
    n_slots = args.slots if args.slots is not None else min(args.requests, 4)
    scfg = ServeConfig(
        n_slots=n_slots,
        # prompts jitter up to +2 tokens below; size the cache for the max
        max_len=args.prompt_len + 2 + args.gen + 8,
        gen_tokens=args.gen,
        sampler=args.sampler,
        backend=args.backend,
        seed=args.seed,
    )
    server = BatchedServer(cfg, scfg, device=args.device)
    rng = np.random.default_rng(args.seed)
    # heterogeneous prompt lengths — the per-row decode index packs them
    queue = FIFOQueue()
    for rid in range(args.requests):
        plen = args.prompt_len + (rid % 3)
        prompt = rng.integers(0, cfg.vocab_size, size=plen)
        queue.push(Request(rid=rid, prompt=prompt))
    finished: list[Request] = []
    steps = 0
    _wait(server.device)
    t0 = time.time()
    while queue or server.active():
        while queue:
            slot = server.free_slot()
            if slot is None:
                break
            server.submit(slot, queue.pop_ready())
        finished.extend(server.step())
        steps += 1
    _wait(server.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in finished)
    backend_note = f", backend={args.backend}" if args.sampler == "mcmc" else ""
    print(
        f"[serve] {args.requests} requests x {args.gen} tokens on "
        f"{n_slots} slots ({args.sampler}{backend_note}): {total_tokens} "
        f"tokens in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)"
    )
    acceptance = float(np.mean(server.acceptance)) if server.acceptance else None
    if server.acceptance:
        print(f"[serve] MCMC acceptance rate: {acceptance:.3f}")
    for r in finished:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    return {
        "requests": args.requests, "slots": n_slots, "sampler": args.sampler,
        "backend": args.backend, "device": str(server.device), "tokens": total_tokens,
        "seconds": dt, "tokens_per_s": total_tokens / dt, "decode_steps": steps,
        "samples": args.requests + steps, "acceptance": acceptance,
        "streams": {r.rid: list(r.out_tokens) for r in finished},
    }


if __name__ == "__main__":
    main()
