"""The port's CLIs — ``repro_torch.launch.{sample,serve_engine,monitor}``
— against the JAX package's (``repro.launch.*``), on the CPU.

``sample.main([... "--device", "cpu"])`` must return the JAX CLI's row:
every field but the wall time, the rate derived from it and the autotune
text is equal — flip/acceptance rate, ESS, split-R-hat, the macro's
energy, swap rates, round trips, best energy.  The JAX side runs its scan
executor for both ``--backend`` values (the JAX package holds its
executors equal; its pallas runs in interpret mode here) at smoke sizes
with short step budgets.  Every compared run's draws are replayed for
tie events (``kernels/*/ref.py``, the tempering drivers' ``tie_events``;
the ``gmm`` table is the port's own, within an ULP of JAX's, so its
window is widened by 4 ULP) and the seeds are asserted free of them.

``serve_engine`` is compared on a mixed smoke burst by its footer and
each request line's rate; ``monitor`` on the JAX test's trace fixture.
Started by ``torchrun``, the CLIs shard over a ``gloo`` group of CPU
ranks and only rank 0 prints.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import monitor as jmonitor
from repro.launch import sample as jsample
from repro.launch import serve_engine as jserve
from repro_torch import prng, telemetry, tempering, workloads
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import ref as mref
from repro_torch.launch import monitor, sample, serve_engine
from repro_torch.samplers import RunPlan, chain_key

ROOT = Path(__file__).resolve().parents[1]
UNTIMED = ("wall_s", "site_steps_per_s", "autotune")

pytestmark = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- tie events ----------------------------------------------------------------


def _port_workload(argv):
    args = sample.build_parser().parse_args(argv + ["--device", "cpu"])
    k_init, k_run = prng.split(prng.PRNGKey(args.seed))
    return args, workloads.build(args.workload, k_init, **sample._workload_kwargs(args)), k_run


def _segment_ties(wl, key, state, target, step0, n):
    backend = wl.engine.randomness
    shape = tuple(state.shape)
    if wl.engine.config.update == "gibbs":
        _, u = backend.chunk(chain_key(key, 0), step0, n, shape, 1, need_flips=False)
        return gref.chain_ties(state, u, target.logit_spec, step0 % 2).shape[0]
    flips, u = backend.chunk(chain_key(key, 0), step0, n, shape, target.nbits)
    return mref.tie_events(target.table, state, flips, u, target.nbits, logp_ulps=4).shape[0]


def assert_no_ties(argv):
    """Replay the run ``argv`` names on the port for tie events."""
    args, wl, k_run = _port_workload(argv)
    if args.ladder:
        ladder = tempering.Ladder.geometric(args.ladder, beta_min=args.beta_min)
        rex = tempering.ReplicaExchange(ladder=ladder, engine=wl.engine,
                                        swap_every=args.swap_every)
        init = wl.init_words.expand(ladder.num_replicas, *wl.init_words.shape)
        ties = rex.tie_events(k_run, wl.target, wl.n_steps, init)
        assert ties == {"moves": 0, "swaps": 0}, ties
        return
    if args.anneal:
        annealer = tempering.Annealer.geometric(args.anneal, max(1, wl.n_steps // args.anneal),
                                                beta_min=args.beta_min, beta_max=args.beta_max)
        state, step, ties = wl.init_words, 0, 0
        for beta in annealer.betas:
            target = tempering.scaled_target(wl.target, beta)
            n = annealer.steps_per_beta
            ties += _segment_ties(wl, k_run, state, target, step, n)
            state = wl.engine.submit(RunPlan(target=target, n_steps=n, init_words=state,
                                             key=k_run, step0=step)).result.final_words
            step += n
        assert ties == 0
        return
    assert _segment_ties(wl, k_run, wl.init_words, wl.target, 0, wl.n_steps) == 0


# --- sample ----------------------------------------------------------------------


_JAX_ROWS = {}


def jax_row(argv):
    """The JAX CLI's row of ``argv`` under its scan executor."""
    key = tuple(argv)
    if key not in _JAX_ROWS:
        assert_no_ties(argv)
        _JAX_ROWS[key] = jsample.main(argv + ["--backend", "scan"])
    return _JAX_ROWS[key]


def assert_rows_equal(got, want, skip=()):
    drop = set(UNTIMED) | set(skip)
    got = {k: v for k, v in got.items() if k not in drop}
    want = {k: v for k, v in want.items() if k not in drop}
    assert got == want


def run_port(argv, backend):
    return sample.main(argv + ["--backend", backend, "--device", "cpu"])


PLAIN = {
    "ising": ["--workload", "ising", "--smoke", "--steps", "32", "--seed", "1"],
    "gmm": ["--workload", "gmm", "--smoke", "--steps", "32", "--seed", "2"],
}


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("workload", list(PLAIN))
def test_sample_row_equals_jax(workload, randomness, backend):
    argv = PLAIN[workload] + ["--randomness", randomness]
    row = run_port(argv, backend)
    assert row["backend"] == backend
    assert_rows_equal(row, jax_row(argv), skip=("backend",))
    assert row["macro_energy_pj"] > 0 and np.isfinite(row["split_rhat"])


@pytest.mark.parametrize("argv", [
    ["--workload", "ising", "--smoke", "--steps", "32", "--randomness", "fused", "--thin", "4"],
    ["--workload", "gmm", "--smoke", "--steps", "32", "--randomness", "fused", "--keep-last"],
    ["--workload", "spin_glass", "--smoke", "--steps", "32", "--randomness", "fused",
     "--ladder", "3", "--swap-every", "8"],
    ["--workload", "spin_glass", "--smoke", "--steps", "16", "--randomness", "fused",
     "--anneal", "2", "--maxcut"],
], ids=["thin", "keep_last", "ladder", "anneal_maxcut"])
def test_sample_modes_equal_jax(argv):
    want = jax_row(argv)
    for backend in ("scan", "pallas"):
        assert_rows_equal(run_port(argv, backend), want, skip=("backend",))


def test_sample_ladder_and_anneal_rows_carry_their_fields():
    ladder = jax_row(["--workload", "spin_glass", "--smoke", "--steps", "32", "--randomness",
                      "fused", "--ladder", "3", "--swap-every", "8"])
    assert {"swap_accept_rate", "pair_accept_rate", "round_trips", "ess"} <= set(ladder)
    anneal = jax_row(["--workload", "spin_glass", "--smoke", "--steps", "16", "--randomness",
                      "fused", "--anneal", "2", "--maxcut"])
    assert {"best_energy", "best_cut"} <= set(anneal)


def test_sample_autotune_keeps_the_row(tmp_path, capsys):
    argv = PLAIN["ising"] + ["--randomness", "fused"]
    cache = str(tmp_path / "tune.json")
    row = run_port(argv + ["--autotune", "--autotune-cache", cache], "auto")
    assert row["autotune"].startswith("chunk") and "(measured" in row["autotune"]
    assert row["backend"] in ("scan", "pallas")
    assert_rows_equal(row, jax_row(argv), skip=("backend",))
    again = run_port(argv + ["--autotune", "--autotune-cache", cache], "auto")
    assert "(cache" in again["autotune"]


def test_sample_trace_and_metrics_exports(tmp_path, capsys):
    trace, metrics = str(tmp_path / "run.trace.jsonl"), str(tmp_path / "m.prom")
    run_port(PLAIN["ising"] + ["--randomness", "fused", "--trace", trace, "--metrics", metrics],
             "pallas")
    assert not telemetry.enabled()
    capsys.readouterr()
    assert monitor.main(["--check", trace]) == 0
    assert "valid trace" in capsys.readouterr().out
    assert monitor.main([trace]) == 0
    assert "span=engine.submit" in capsys.readouterr().out
    assert os.path.getsize(metrics) > 0


def test_sample_parser_refusals():
    with pytest.raises(SystemExit):
        sample.main(["--workload", "ising", "--smoke", "--ladder", "2", "--anneal", "2",
                     "--device", "cpu"])
    with pytest.raises(SystemExit):
        sample.main(["--workload", "ising", "--smoke", "--ladder", "2", "--thin", "2",
                     "--device", "cpu"])
    with pytest.raises(SystemExit):
        sample.main(["--workload", "ising", "--smoke", "--device", "tpu"])


def test_clis_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--workload", "ising", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_engine.main(["--smoke", "--requests", "1"])


# --- serve_engine ------------------------------------------------------------------


SERVE = ["--smoke", "--workload", "gmm,ising", "--requests", "4", "--slots", "2",
         "--randomness", "fused", "--collect", "all"]
REQ_LINE = re.compile(r"req (\d+): workload=(\w+) .* (acceptance_rate|flip_rate)=([0-9.]+)")


def _req_rates(out):
    return sorted(m.groups() for m in REQ_LINE.finditer(out))


@pytest.fixture(scope="module")
def jax_serve():
    """(footer row, request rate lines) of the JAX CLI's burst."""
    import contextlib
    import io

    for rid in range(4):
        workload = ("gmm", "ising")[rid % 2]
        assert_no_ties(["--workload", workload, "--smoke", "--seed", str(rid),
                        "--randomness", "fused"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        row = jserve.main(SERVE)
    return row, _req_rates(buf.getvalue())


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_serve_engine_equals_jax(jax_serve, capsys, backend):
    want_row, want_rates = jax_serve
    row = serve_engine.main(SERVE + ["--device", "cpu", "--backend", backend])
    rates = _req_rates(capsys.readouterr().out)
    assert len(rates) == 4 and rates == want_rates
    assert row["n_requests"] == want_row["n_requests"] == 4
    if backend == "scan":
        assert row["shape_classes"] == want_row["shape_classes"] == 1
        assert row["compiled_programs"] == want_row["compiled_programs"]
    else:
        assert row["shape_classes"] == 2  # one kernel geometry a workload


def test_serve_engine_spec_autotune_and_exports(tmp_path, capsys):
    spec = tmp_path / "reqs.jsonl"
    spec.write_text('{"workload": "gmm", "n_steps": 16, "seed": 1}\n\n'
                    '{"workload": "ising", "n_steps": 8, "seed": 2, "t_arrive": 0.001}\n')
    trace, metrics = str(tmp_path / "s.trace.jsonl"), str(tmp_path / "m.jsonl")
    row = serve_engine.main(["--smoke", "--device", "cpu", "--randomness", "fused", "--spec",
                             str(spec), "--autotune", "--autotune-cache",
                             str(tmp_path / "tune.json"), "--trace", trace, "--metrics",
                             metrics, "--slo-p99", "1e-9"])
    out = capsys.readouterr().out
    assert row["n_requests"] == 2 and "autotune: chunk_steps=" in out
    assert "[health]" in out  # the impossible SLO is breached
    assert monitor.main(["--check", trace]) == 0
    assert os.path.getsize(metrics) > 0


# --- monitor ---------------------------------------------------------------------------


def _trace_fixture(tmp_path):
    """The JAX test's fixture (``tests/test_telemetry.py:TestMonitorCLI``),
    written by the port's tracer."""
    tr = telemetry.enable()
    with tr.span("engine.submit", n_steps=4):
        pass
    tr.log("health.rhat_divergence", split_rhat=2.0)
    path = str(tmp_path / "out.trace.jsonl")
    tr.export_jsonl(path)
    telemetry.disable()
    return path


def test_monitor_check_and_summary_equal_jax(tmp_path, capsys):
    path = _trace_fixture(tmp_path)
    for cli in (monitor, jmonitor):
        assert cli.main(["--check", path]) == 0
        assert "valid trace" in capsys.readouterr().out
        assert cli.main([path]) == 0
        out = capsys.readouterr().out
        assert "span=engine.submit" in out and "count=1" in out
        assert "health.rhat_divergence" in out
    assert monitor.read_events(path) == jmonitor.read_events(path)


def test_monitor_check_invalid_trace(tmp_path, capsys):
    bad = tmp_path / "bad.trace.jsonl"
    bad.write_text('{"kind": "span", "name": ""}\n')
    assert monitor.main(["--check", str(bad)]) == 1 == jmonitor.main(["--check", str(bad)])
    assert "INVALID" in capsys.readouterr().out


def test_monitor_summarize_events_equals_jax():
    events = [
        {"kind": "span", "name": "a", "dur_us": 30.0},
        {"kind": "span", "name": "a", "dur_us": 10.0},
        {"kind": "span", "name": "b", "dur_us": 60.0},
        {"kind": "instant", "name": "c"},
    ]
    rows = monitor.summarize_events(events)
    assert rows == jmonitor.summarize_events(events)
    assert rows[0]["span"] == "b" and rows[0]["share"] == 0.6
    assert monitor.summarize_events(events, top=1) == rows[:1]


# --- torchrun ------------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(module, argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port", str(_free_port()),
         "-m", module, *argv],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_torchrun_sample_shards_chains_and_rank0_prints(capsys):
    argv = ["--workload", "ising", "--smoke", "--steps", "16", "--randomness", "fused",
            "--num-chains", "4", "--backend", "pallas", "--device", "cpu"]
    out = _torchrun("repro_torch.launch.sample", argv)
    rows = [line for line in out.splitlines() if line.startswith("workload=")]
    assert len(rows) == 1  # rank 0 alone prints
    sample.main(argv)  # unsharded, in this process
    want = capsys.readouterr().out.splitlines()[0]
    strip = re.compile(r"\s+(wall_s|site_steps_per_s)=\S+")
    assert strip.sub("", rows[0]) == strip.sub("", want)


@pytest.mark.parametrize("autotune", [False, True], ids=["fixed_chunk", "autotune"])
def test_torchrun_serve_engine_mesh(capsys, tmp_path, autotune):
    """The slot axis sharded over 2 ``gloo`` ranks serves what one
    process serves.  With ``--autotune`` rank 0 alone measures the chunk
    size and broadcasts it, so both ranks cut the same segments."""
    argv = ["--smoke", "--workload", "gmm,ising", "--requests", "4", "--slots", "2",
            "--randomness", "fused", "--collect", "all", "--mesh", "--device", "cpu"]
    if autotune:
        argv += ["--autotune", "--autotune-cache", str(tmp_path / "tune.json")]
    out = _torchrun("repro_torch.launch.serve_engine", argv)
    assert out.count("[serve_engine] slots=") == 1  # rank 0 alone prints
    assert out.count("[serve_engine] autotune: chunk_steps=") == int(autotune)
    if autotune:
        assert "(measured," in out and len(json.loads((tmp_path / "tune.json").read_text())) == 1
    serve_engine.main(argv)  # one process: unsharded
    local = capsys.readouterr().out
    assert "serving unsharded" in local
    assert _req_rates(out) == _req_rates(local)
