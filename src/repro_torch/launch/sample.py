"""Run a workload from the probabilistic-model zoo and report diagnostics —
the PyTorch port of ``repro.launch.sample``, on the card unless
``--device cpu`` is asked for.

Pick a workload from the registry (2-D Ising via checkerboard Gibbs, GMM
posterior via MH, ±J spin glass), a randomness backend (ideal host, the
paper's CIM pipeline, or the fused in-kernel cipher) and an executor
(scan, or ``pallas``: the CUDA kernels), run the chains, and print
throughput plus chain diagnostics (flip/acceptance rate, integrated
autocorrelation time, ESS, split-R-hat).  Keys come from
``prng.PRNGKey(seed)`` split as the JAX CLI splits them, so a row's
deterministic fields equal the JAX CLI's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sample --workload ising \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sample --workload ising \\
      --height 1024 --width 1024 --batch 4 --randomness fused \\
      --backend pallas --steps 1024 --thin 16
  PYTHONPATH=src python -m repro_torch.launch.sample --workload gmm \\
      --backend pallas

  # parallel tempering / simulated annealing on the same target
  PYTHONPATH=src python -m repro_torch.launch.sample --workload spin_glass \\
      --smoke --ladder 8 --beta-min 0.25 --swap-every 16
  PYTHONPATH=src python -m repro_torch.launch.sample --workload spin_glass \\
      --smoke --anneal 8 --beta-min 0.4 --beta-max 4.0

  # chains sharded over the cards, one process each
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.sample \\
      --workload ising --num-chains 8 --backend pallas

``--num-chains C`` runs C independent chains; started by ``torchrun``
(``WORLD_SIZE`` > 1), the CLI joins the process group (``nccl`` on
cards, ``gloo`` under ``--device cpu``) and shards the chain axis over a
1-D mesh of its ranks, word for word the unsharded run; only rank 0
prints.  Workload knobs come from the ``workloads.WORKLOADS`` builders'
signatures (flags a builder does not accept are not forwarded).
"""

from __future__ import annotations

import argparse
import inspect
import time

from repro_torch import diagnostics, prng, samplers, telemetry, tempering, workloads
from repro_torch.core import energy
from repro_torch.launch.mesh import make_chains_mesh, torchrun_group
from repro_torch.samplers.engine import _wait


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.sample",
        description="Sample a zoo workload on the unified engine (PyTorch port).",
    )
    p.add_argument("--workload", required=True, choices=sorted(workloads.WORKLOADS))
    p.add_argument(
        "--randomness", default="cim", choices=("host", "cim", "fused"),
        help="operand source: host PRNG, the CIM pseudo-read+MSXOR pipeline, "
        "or the cipher drawn inside the kernels (no operand traffic under "
        "--backend pallas)",
    )
    p.add_argument("--backend", default="auto", choices=("auto", "scan", "pallas"))
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the engine runs: the card (default; raises without one) "
        "or the CPU (the kernels' plain versions)",
    )
    p.add_argument("--smoke", action="store_true", help="tiny sizes for CPU runs")
    p.add_argument("--steps", type=int, default=None, help="chain steps")
    p.add_argument(
        "--num-chains", type=int, default=1,
        help="independent chains run in one engine call",
    )
    coll = p.add_mutually_exclusive_group()
    coll.add_argument(
        "--thin", type=int, default=None, metavar="K",
        help="keep every K-th absolute step (engine collect='thin:K'); "
        "diagnostics run on the kept stream",
    )
    coll.add_argument(
        "--keep-last", action="store_true",
        help="keep only the final state (engine collect='last'); series "
        "diagnostics skipped",
    )
    p.add_argument("--seed", type=int, default=0)
    # lattice knobs (ising / spin_glass)
    p.add_argument("--height", type=int, default=None, help="lattice H")
    p.add_argument("--width", type=int, default=None, help="lattice W")
    p.add_argument("--batch", type=int, default=None, help="lattices")
    p.add_argument("--beta", type=float, default=None, help="ising coupling")
    p.add_argument("--field", type=float, default=0.0, help="external field")
    p.add_argument(
        "--maxcut", action="store_true",
        help="spin_glass: signed MAX-CUT couplings (J = -w); tempered rows "
        "then report best_cut",
    )
    # gmm knobs
    p.add_argument("--nbits", type=int, default=None, help="gmm grid bits")
    p.add_argument("--chains", type=int, default=None, help="gmm chains")
    # tempering
    p.add_argument(
        "--ladder", type=int, default=0, metavar="R",
        help="parallel tempering with R replicas on a geometric ladder",
    )
    p.add_argument("--swap-every", type=int, default=16,
                   help="replica-exchange period in engine steps")
    p.add_argument(
        "--anneal", type=int, default=0, metavar="S",
        help="simulated annealing over S geometric cooling stages",
    )
    p.add_argument(
        "--autotune", action="store_true",
        help="replace the hand-chosen chunk_steps/backend with the measured "
        "per-(workload, shape, device) winner (cached)",
    )
    p.add_argument(
        "--autotune-cache", default=None, metavar="PATH",
        help="autotune cache file (default $REPRO_TORCH_AUTOTUNE_CACHE or "
        "~/.cache/repro_torch/autotune.json)",
    )
    p.add_argument("--beta-min", type=float, default=0.25,
                   help="hottest ladder beta / annealing start beta")
    p.add_argument("--beta-max", type=float, default=4.0,
                   help="annealing end beta (annealing only; ladders end at 1.0)")
    # telemetry
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="record host-side trace spans and export on exit: "
        "*.json/*.trace -> Chrome-trace, anything else -> JSONL (validate "
        "or summarize with python -m repro_torch.launch.monitor)",
    )
    p.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="write the final metrics snapshot: *.prom/*.txt -> Prometheus "
        "exposition text, anything else -> one JSONL line",
    )
    return p


def _export_telemetry(args, say) -> None:
    if args.trace:
        n = telemetry.TRACER.export(args.trace)
        say(f"[trace] wrote {n} events to {args.trace}")
        telemetry.disable()
    if args.metrics:
        if args.metrics.endswith((".prom", ".txt")):
            with open(args.metrics, "w") as f:
                f.write(telemetry.REGISTRY.prometheus_text())
        else:
            telemetry.REGISTRY.flush_jsonl(args.metrics)
        say(f"[metrics] wrote snapshot to {args.metrics}")


def _collect_arg(args) -> str:
    """The engine collection spec the CLI flags select."""
    if args.thin is not None:
        if args.thin < 1:
            raise SystemExit(f"--thin must be >= 1, got {args.thin}")
        return f"thin:{args.thin}"
    return "last" if args.keep_last else "all"


def _workload_kwargs(args) -> dict:
    """Forward exactly the flags the registered builder accepts."""
    candidates = dict(
        randomness=args.randomness,
        backend=args.backend,
        smoke=args.smoke,
        n_steps=args.steps,
        num_chains=args.num_chains,
        collect=_collect_arg(args),
        height=args.height,
        width=args.width,
        batch=args.batch,
        beta=args.beta,
        field=args.field,
        maxcut=args.maxcut,
        nbits=args.nbits,
        chains=args.chains,
        device=args.device,
    )
    params = inspect.signature(workloads.WORKLOADS[args.workload]).parameters
    return {k: v for k, v in candidates.items() if k in params}


def _series_diagnostics(wl, samples) -> dict:
    """Post-burn-in diagnostics of the workload statistic over one
    (solo-shaped) sample block."""
    series = wl.series_fn(samples).cpu().numpy()
    series = series.reshape(series.shape[0], -1)
    return diagnostics.summarize(series[wl.burn_in:])


def _run_ladder(args, wl, k_run, monitor) -> dict:
    ladder = tempering.Ladder.geometric(args.ladder, beta_min=args.beta_min)
    rex = tempering.ReplicaExchange(ladder=ladder, engine=wl.engine, swap_every=args.swap_every)
    init = wl.init_words.expand(ladder.num_replicas, *wl.init_words.shape)
    t0 = time.time()
    result = rex.run(k_run, wl.target, wl.n_steps, init)
    _wait(wl.engine.device)
    wall_s = time.time() - t0

    site_steps = wl.n_steps * init.numel()
    diag = _series_diagnostics(wl, result.cold_samples)
    monitor.check_acceptance(float(result.acceptance_rate), label=wl.rate_key, where=wl.name)
    monitor.check_swap_stats(result.swap, where=wl.name)
    monitor.check_chain_stats(diag, where=wl.name)
    row = {
        "mode": "ladder",
        "num_replicas": ladder.num_replicas,
        "swap_every": args.swap_every,
        "beta_min": round(min(ladder.betas), 4),
        "n_steps": wl.n_steps,
        "wall_s": round(wall_s, 3),
        "site_steps_per_s": round(site_steps / max(wall_s, 1e-9), 1),
        wl.rate_key: round(float(result.acceptance_rate), 4),
        **result.swap.summary(),
        # sample quality of the cold (beta = betas[0]) replica
        **{("kept_steps" if k == "n_steps" else k): v for k, v in diag.items()},
    }
    if getattr(wl.target, "maxcut_reduction", False):
        row["best_cut"] = round(float(wl.target.cut_value(result.cold_samples).max()), 4)
    return row


def _run_anneal(args, wl, k_run, monitor) -> dict:
    annealer = tempering.Annealer.geometric(
        args.anneal, max(1, wl.n_steps // args.anneal),
        beta_min=args.beta_min, beta_max=args.beta_max,
    )
    t0 = time.time()
    result = annealer.run(k_run, wl.target, wl.init_words, engine=wl.engine)
    _wait(wl.engine.device)
    wall_s = time.time() - t0

    site_steps = result.n_steps * wl.init_words.numel()
    monitor.check_acceptance(float(result.acceptance_rate), label=wl.rate_key, where=wl.name)
    row = {
        "mode": "anneal",
        "stages": args.anneal,
        "beta_min": round(min(annealer.betas), 4),
        "beta_max": round(max(annealer.betas), 4),
        "n_steps": result.n_steps,
        "wall_s": round(wall_s, 3),
        "site_steps_per_s": round(site_steps / max(wall_s, 1e-9), 1),
        wl.rate_key: round(float(result.acceptance_rate), 4),
        # lattice targets: best_logp is -energy, report the best energy
        "best_energy": round(float(-result.best_logp.max()), 4),
    }
    if getattr(wl.target, "maxcut_reduction", False):
        row["best_cut"] = round(float(wl.target.cut_value(result.best_words).max()), 4)
    return row


def _run_plain(args, wl, k_run, monitor, base) -> dict:
    mesh = make_chains_mesh(args.num_chains, device_type=args.device)
    t0 = time.time()
    result = wl.run(k_run, mesh=mesh)
    _wait(wl.engine.device)
    wall_s = time.time() - t0

    diag = wl.diagnostics(result)
    monitor.check_acceptance(float(result.acceptance_rate), label=wl.rate_key, where=wl.name)
    monitor.check_chain_stats(diag, where=wl.name)
    n_sites = wl.init_words.numel()
    site_steps = wl.n_steps * n_sites
    nbits = int(wl.meta.get("nbits", wl.target.nbits))
    macro_fj = energy.energy_per_sample_fj(float(result.acceptance_rate), nbits) * site_steps
    return {
        **base,
        "n_steps": wl.n_steps,
        "burn_in": wl.burn_in,
        "n_sites": n_sites,
        "wall_s": round(wall_s, 3),
        "site_steps_per_s": round(site_steps / max(wall_s, 1e-9), 1),
        "macro_energy_pj": round(macro_fj * 1e-3, 2),
        **{k: v for k, v in wl.meta.items() if k != "nbits"},
        **{("kept_steps" if k == "n_steps" else k): v for k, v in diag.items()},
    }


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ladder and args.anneal:
        parser.error("--ladder and --anneal are mutually exclusive")
    if (args.ladder or args.anneal) and args.num_chains > 1:
        parser.error(
            "--ladder/--anneal occupy the engine's chain-id axis; batch the "
            "workload (e.g. --batch/--chains) for parallel ensembles"
        )
    if (args.ladder or args.anneal) and (args.thin is not None or args.keep_last):
        parser.error(
            "--thin/--keep-last apply to plain runs; the tempering drivers "
            "consume the full segment streams for their own diagnostics/"
            "best-state tracking"
        )
    with torchrun_group(args.device) as rank:
        say = print if rank == 0 else (lambda *a, **k: None)
        if args.trace:
            telemetry.enable()
        monitor = telemetry.HealthMonitor(warn=False)
        k_init, k_run = prng.split(prng.PRNGKey(args.seed))
        wl = workloads.build(args.workload, k_init, **_workload_kwargs(args))

        base = {
            "workload": wl.name,
            "update": wl.engine.config.update,
            "randomness": args.randomness,
            "backend": args.backend,
            "collect": _collect_arg(args),
        }
        if args.autotune:
            wl.engine, tuned = samplers.autotune_engine(
                wl.engine, wl.target, wl.init_words, cache_path=args.autotune_cache,
            )
            base["backend"] = tuned.execution
            base["autotune"] = (
                f"chunk{tuned.chunk_steps}:{tuned.execution} ({tuned.source}, "
                f"{tuned.steps_per_s / max(tuned.baseline_steps_per_s, 1e-9):.2f}x"
                " vs incumbent)"
            )
        if args.ladder:
            row = {**base, **_run_ladder(args, wl, k_run, monitor)}
        elif args.anneal:
            row = {**base, **_run_anneal(args, wl, k_run, monitor)}
        else:
            row = _run_plain(args, wl, k_run, monitor, base)
        say("  ".join(f"{k}={v}" for k, v in row.items()))
        for alert in monitor.alerts:
            say(f"[health] {alert.severity} {alert.kind}: {alert.message}")
        if rank == 0:
            _export_telemetry(args, say)
        elif args.trace:
            telemetry.disable()
    return row


if __name__ == "__main__":
    main()
