"""Serve concurrent MCMC sampling requests on the packed chain engine —
the PyTorch port of ``repro.launch.serve_engine``, on the card unless
``--device cpu`` is asked for.

Heterogeneous requests — each a (workload, n_steps, seed, collect) tuple
— are packed into the slot axis of one engine call a chunk by
``repro_torch.serving``.  Admission and retirement happen between
``chunk_steps`` segments via the engine's ``step0`` resume axis, so
every request's sample stream equals its solo ``launch.sample``-style
run no matter when it joined or who shared the batch.

Requests come from a JSONL spec (one object per line with any of
``rid / workload / n_steps / seed / collect / t_arrive``) or from a
synthetic Poisson arrival generator (``--poisson-rate`` arrivals/s,
seeds 0..N-1).  Arrival gaps are fast-forwarded by default; pass
``--realtime`` to sleep through them.

``--workload`` takes a comma-separated list for a mixed burst
(round-robin assignment): under scan execution every workload shares
one shape class; under pallas each workload gets one packed kernel call
over all its slots a chunk.  ``--mesh`` shards the slot axis over the
ranks of a ``torchrun`` launch (scan only; ``nccl`` on cards, ``gloo``
under ``--device cpu``); only rank 0 prints.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_engine --smoke \\
      --device cpu --requests 6 --slots 3 --poisson-rate 50
  PYTHONPATH=src python -m repro_torch.launch.serve_engine \\
      --workload gmm,ising --backend pallas --randomness fused \\
      --slots 4 --requests 12 --poisson-rate 200
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.serve_engine --mesh --backend scan --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_engine --spec requests.jsonl

Per-request lines report wait/latency and the accept (MH) or flip
(Gibbs) rate; the footer is the ``latency_summary`` row (requests/s,
p50/p99 latency).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch import prng, samplers, telemetry, workloads
from repro_torch.launch.mesh import make_chains_mesh, torchrun_group
from repro_torch.serving import Scheduler, ServeRequest, latency_summary


def _workload_list(value: str) -> list[str]:
    names = [w.strip() for w in value.split(",") if w.strip()]
    if not names:
        raise argparse.ArgumentTypeError("empty workload list")
    for name in names:
        if name not in workloads.WORKLOADS:
            raise argparse.ArgumentTypeError(
                f"unknown workload {name!r} (choices: "
                f"{', '.join(sorted(workloads.WORKLOADS))})"
            )
    return names


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.serve_engine",
        description="Serve sampling requests packed into one engine call (PyTorch port).",
    )
    p.add_argument(
        "--workload", default=["ising"], type=_workload_list,
        help="workload for synthetic requests, or a comma-separated list "
        "(round-robin assignment) for a mixed burst; JSONL specs name "
        "their own.  Choices: " + ", ".join(sorted(workloads.WORKLOADS)),
    )
    p.add_argument("--randomness", default="cim", choices=("host", "cim", "fused"))
    p.add_argument(
        "--backend", default="scan", choices=("auto", "scan", "pallas"),
        help="engine execution: scan packs every workload into one shape "
        "class (each slot its solo call); pallas folds all slots of a "
        "workload into one kernel call a chunk",
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the executors run: the card (default; raises without "
        "one) or the CPU",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="shard the slot axis over the ranks of a torchrun launch "
        "through the 'chains' sharding rule (scan backend only; unsharded "
        "in one process)",
    )
    p.add_argument("--smoke", action="store_true", help="tiny sizes for CPU runs")
    p.add_argument("--slots", type=int, default=4, help="packed slot pool")
    p.add_argument(
        "--requests", type=int, default=8,
        help="synthetic request count (overflow waits in the FIFO)",
    )
    p.add_argument(
        "--steps", type=int, default=None,
        help="steps per synthetic request (default: workload default)",
    )
    p.add_argument(
        "--collect", default="last",
        help="collection mode for synthetic requests: all | thin:<k> | last "
        "(the serving default — O(state) memory)",
    )
    p.add_argument(
        "--chunk-steps", type=int, default=None,
        help="admission/retirement granularity (default: engine chunk)",
    )
    p.add_argument(
        "--autotune", action="store_true",
        help="measure chunk_steps for the workload template before serving "
        "(samplers.autotune; cached per workload/shape/device)",
    )
    p.add_argument(
        "--autotune-cache", default=None, metavar="PATH",
        help="autotune cache file (default: $REPRO_TORCH_AUTOTUNE_CACHE or "
        "~/.cache/repro_torch/autotune.json)",
    )
    p.add_argument(
        "--poisson-rate", type=float, default=0.0,
        help="mean synthetic arrivals/s (0 = all requests arrive at t=0)",
    )
    p.add_argument(
        "--spec", default=None, metavar="PATH",
        help="JSONL request spec; overrides the synthetic generator",
    )
    p.add_argument(
        "--realtime", action="store_true",
        help="sleep through arrival gaps instead of fast-forwarding",
    )
    p.add_argument("--seed", type=int, default=0, help="arrival-process seed")
    # telemetry + SLO health
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="record host-side trace spans and export on exit "
        "(*.json/*.trace -> Chrome-trace, else JSONL)",
    )
    p.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="flush metrics snapshots: *.prom/*.txt -> final Prometheus "
        "text, anything else -> periodic JSONL lines from the serve loop",
    )
    p.add_argument(
        "--metrics-interval", type=float, default=5.0,
        help="seconds between periodic JSONL metrics flushes",
    )
    p.add_argument(
        "--slo-p99", type=float, default=None, metavar="SECONDS",
        help="p99 end-to-end latency SLO; breach prints a [health] line",
    )
    p.add_argument(
        "--slo-wait", type=float, default=None, metavar="SECONDS",
        help="p99 queue-wait SLO; breach prints a [health] line",
    )
    return p


def load_spec(path: str) -> list[ServeRequest]:
    """Requests from a JSONL file, one object per line; missing fields
    take the ``ServeRequest`` defaults, ``rid`` defaults to the line
    number."""
    requests = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            obj.setdefault("rid", i)
            requests.append(ServeRequest(**obj))
    return requests


def poisson_requests(args) -> list[ServeRequest]:
    """N synthetic requests with Poisson arrivals (exponential gaps at
    ``--poisson-rate``; rate 0 = a burst at t=0) and seeds 0..N-1."""
    rng = np.random.default_rng(args.seed)
    t = 0.0
    requests = []
    names = args.workload
    for rid in range(args.requests):
        if args.poisson_rate > 0:
            t += float(rng.exponential(1.0 / args.poisson_rate))
        requests.append(
            ServeRequest(
                rid=rid,
                workload=names[rid % len(names)],  # round-robin mixed burst
                n_steps=args.steps,
                seed=rid,
                collect=args.collect,
                t_arrive=t,
            )
        )
    return requests


def _autotuned_chunk(args, say) -> int:
    """The segment granularity measured on the first workload's template
    engine and target; execution stays as the ``--backend`` pin (the
    serving tier's packing is chosen there, not by throughput alone)."""
    wl = workloads.build(
        args.workload[0], prng.PRNGKey(0), randomness=args.randomness, smoke=args.smoke,
        device=args.device,
    )
    cfg = wl.engine.config
    if args.backend in ("scan", "pallas"):
        cfg = dataclasses.replace(cfg, execution=args.backend)
    _, tuned = samplers.autotune_config(
        cfg, wl.target, wl.init_words, cache_path=args.autotune_cache, device=wl.engine.device,
    )
    say(
        f"[serve_engine] autotune: chunk_steps={tuned.chunk_steps} "
        f"({tuned.source}, {tuned.steps_per_s:.3g} site-steps/s vs "
        f"incumbent {tuned.baseline_steps_per_s:.3g})"
    )
    return tuned.chunk_steps


def _tuned_chunk(args, say, rank) -> int:
    """``_autotuned_chunk`` measured on rank 0 alone and broadcast to the
    ranks of a ``torchrun`` launch: every rank must cut the same segments,
    or a mesh's per-chunk all-gathers would not line up."""
    import torch.distributed as dist

    chunk = [_autotuned_chunk(args, say) if rank == 0 else None]
    if dist.is_available() and dist.is_initialized():
        dist.broadcast_object_list(chunk, src=0)
    return int(chunk[0])


def _serve(args, requests, rank) -> dict:
    """One rank's serve loop, its report and its exports; returns the
    footer row.  The scheduler and its mesh die with this call."""
    say = print if rank == 0 else (lambda *a, **k: None)
    chunk_steps = args.chunk_steps
    if args.autotune and chunk_steps is None:
        chunk_steps = _tuned_chunk(args, say, rank)
    if args.trace:
        telemetry.enable()
    mesh = None
    if args.mesh:
        mesh = make_chains_mesh(device_type=args.device)
        if mesh is None:
            say("[serve_engine] --mesh: one process, serving unsharded")
    sched = Scheduler(
        n_slots=args.slots,
        randomness=args.randomness,
        execution=args.backend,
        smoke=args.smoke,
        chunk_steps=chunk_steps,
        mesh=mesh,
        device=args.device,
    )
    if args.metrics and not args.metrics.endswith((".prom", ".txt")) and rank == 0:
        sched.metrics_flusher = telemetry.JsonlFlusher(
            telemetry.REGISTRY, args.metrics, interval_s=args.metrics_interval,
        )
    done = sched.serve(requests, realtime=args.realtime)
    for r in sorted(done, key=lambda r: r.rid):
        n_kept = 0 if r.samples is None else r.samples.shape[0]
        say(
            f"  req {r.rid}: workload={r.workload} steps="
            f"{r.n_steps or 'default'} collect={r.collect} kept={n_kept} "
            f"wait_s={r.wait_s:.3f} service_s={r.service_s:.3f} "
            f"latency_s={r.latency_s:.3f} "
            f"{r.rate_label}={r.acceptance_rate:.4f}"
        )
    summary = latency_summary(done)
    row = {
        "slots": args.slots,
        "randomness": args.randomness,
        "backend": args.backend,
        "shape_classes": sched.shape_classes,
        "compiled_programs": sched.compiled_programs,
        **summary,
    }
    say("[serve_engine] " + "  ".join(f"{k}={v}" for k, v in row.items()))
    monitor = telemetry.HealthMonitor(
        telemetry.HealthThresholds(
            p99_latency_slo_s=args.slo_p99, max_wait_slo_s=args.slo_wait
        ),
        warn=False,
    )
    monitor.check_serving(summary, where=",".join(args.workload))
    for alert in monitor.alerts:
        say(f"[health] {alert.severity} {alert.kind}: {alert.message}")
    if args.trace:
        if rank == 0:
            n = telemetry.TRACER.export(args.trace)
            say(f"[trace] wrote {n} events to {args.trace}")
        telemetry.disable()
    if args.metrics and rank == 0:
        if args.metrics.endswith((".prom", ".txt")):
            with open(args.metrics, "w") as f:
                f.write(telemetry.REGISTRY.prometheus_text())
        else:
            sched.metrics_flusher.close()
        say(f"[metrics] wrote snapshot to {args.metrics}")
    return row


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    requests = load_spec(args.spec) if args.spec else poisson_requests(args)
    with torchrun_group(args.device) as rank:
        # the scheduler and its mesh live in _serve, so none outlives the group
        return _serve(args, requests, rank)


if __name__ == "__main__":
    main()
