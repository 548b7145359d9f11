"""The port's telemetry (``repro_torch.telemetry``, a copy of
``repro.telemetry``): the tracing core, the metrics registry and the
health monitor, held to the JAX package's own tests
(``tests/test_telemetry.py``: ``TestTracer``, ``TestMetrics``,
``TestHealth``); and the instrumentation contracts — the sampled stream
is bit-identical with telemetry on and off, every ``engine.submit`` is
one span, ``run_resumable`` logs its segments and restores, and no
telemetry module can read a device value (standard library only).
"""

import ast
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import telemetry as jax_telemetry
from repro_torch import telemetry
from repro_torch import samplers as ts
from repro_torch.checkpoint import run_resumable
from repro_torch.diagnostics import SwapStats
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracing import Tracer
from repro_torch.workloads.ising import IsingModel

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_global_telemetry():
    """Tests share the process-default tracer/registry: leave both off
    and empty regardless of what a test did."""
    yield
    telemetry.disable()
    telemetry.TRACER.reset()
    telemetry.REGISTRY.reset()


def _mh_setup(seed=0):
    rs = np.random.default_rng(seed)
    table = rs.normal(size=(2, 64)).astype(np.float32)
    init = np.broadcast_to(np.argmax(table, -1).astype(np.uint32)[:, None], (2, 8)).copy()
    return ts.TableTarget(torch.from_numpy(table)), init


def _gibbs_setup(seed=1):
    rs = np.random.default_rng(seed)
    return IsingModel(6, 6), rs.integers(0, 2, size=(2, 6, 6)).astype(np.uint32)


def _engine(**kw):
    return ts.MHEngine(ts.EngineConfig(**kw), device="cpu")


def test_public_names_equal_jax():
    assert telemetry.__all__ == jax_telemetry.__all__
    assert telemetry.SCHEMA_VERSION == jax_telemetry.SCHEMA_VERSION


def test_telemetry_imports_only_the_standard_library():
    """No telemetry module imports torch (or anything but the standard
    library and itself), so no span, counter or log can synchronise the
    card or read a device value."""
    for path in sorted((ROOT / "src" / "repro_torch" / "telemetry").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top == "repro_torch" or top in sys.stdlib_module_names or top == "__future__", (
                    f"{path.name} imports {name}")


# --------------------------------------------------------------------------
# tracing core
# --------------------------------------------------------------------------


class TestTracer:
    def test_span_nesting_and_ordering(self):
        tr = Tracer()
        tr.enabled = True
        with tr.span("outer", a=1):
            with tr.span("inner"):
                pass
            with tr.span("inner2"):
                pass
        evs = tr.events()
        # spans record on exit: inner events precede the outer one
        assert [e.name for e in evs] == ["inner", "inner2", "outer"]
        assert [e.depth for e in evs] == [1, 1, 0]
        assert [e.seq for e in evs] == [0, 1, 2]
        assert all(e.dur_us >= 0 for e in evs)
        outer = evs[-1]
        assert outer.meta == {"a": 1}
        # the outer span covers its children in time
        assert outer.ts_us <= evs[0].ts_us
        assert outer.ts_us + outer.dur_us >= evs[1].ts_us + evs[1].dur_us

    def test_disabled_span_is_shared_noop(self):
        tr = Tracer()
        s1 = tr.span("x", big=1)
        s2 = tr.span("y")
        assert s1 is s2  # no allocation on the disabled path
        with s1 as s:
            s.set(late="metadata")  # no-op parity with the live span
        assert tr.events() == []

    def test_late_metadata_via_set(self):
        tr = Tracer()
        tr.enabled = True
        with tr.span("submit") as sp:
            sp.set(jit_cache="miss")
        (ev,) = tr.events()
        assert ev.meta["jit_cache"] == "miss"

    def test_meta_cleaned_to_json_scalars(self):
        tr = Tracer()
        tr.enabled = True
        with tr.span("s", arr=np.arange(3), ok=2.5, flag=True, none=None):
            pass
        (ev,) = tr.events()
        assert ev.meta["ok"] == 2.5 and ev.meta["flag"] is True
        assert ev.meta["none"] is None
        assert isinstance(ev.meta["arr"], str)  # repr()'d, never a crash
        json.dumps(ev.to_json())  # always serialisable

    def test_ring_overflow_drops_oldest(self):
        tr = Tracer(capacity=4)
        tr.enabled = True
        for i in range(7):
            tr.instant(f"e{i}")
        evs = tr.events()
        assert len(evs) == 4
        assert [e.name for e in evs] == ["e3", "e4", "e5", "e6"]
        assert tr.dropped == 3

    def test_reset_restarts_epoch_and_seq(self):
        tr = Tracer()
        tr.enabled = True
        tr.instant("a")
        tr.reset()
        assert tr.events() == [] and tr.dropped == 0
        tr.instant("b")
        assert tr.events()[0].seq == 0

    def test_export_jsonl_roundtrip_and_validate(self, tmp_path):
        tr = Tracer()
        tr.enabled = True
        with tr.span("s", k="v"):
            tr.instant("i", n=2)
        path = str(tmp_path / "out.trace.jsonl")
        n = tr.export_jsonl(path)
        assert n == 2
        assert telemetry.validate_jsonl(path) == []
        lines = [json.loads(line) for line in open(path)]
        assert lines[0]["kind"] == "trace_meta"
        assert lines[0]["schema"] == telemetry.SCHEMA_VERSION
        assert lines[0]["events"] == 2 and lines[0]["dropped"] == 0

    def test_export_chrome_trace_is_valid(self, tmp_path):
        tr = Tracer()
        tr.enabled = True
        with tr.span("seg", step0=4):
            tr.instant("mark")
        path = str(tmp_path / "out.trace.json")
        tr.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        assert len(evs) == 2
        span = next(e for e in evs if e["ph"] == "X")
        assert span["name"] == "seg" and span["dur"] >= 0
        assert {"ts", "pid", "tid"} <= span.keys()
        inst = next(e for e in evs if e["ph"] == "i")
        assert inst["name"] == "mark"
        assert doc["otherData"]["schema"] == telemetry.SCHEMA_VERSION

    def test_export_format_by_extension(self, tmp_path):
        tr = Tracer()
        tr.enabled = True
        tr.instant("x")
        chrome = str(tmp_path / "a.json")
        jsonl = str(tmp_path / "a.trace.jsonl")
        tr.export(chrome)
        tr.export(jsonl)
        json.load(open(chrome))  # one JSON object
        assert telemetry.validate_jsonl(jsonl) == []

    def test_validate_rejects_bad_events(self, tmp_path):
        bad = tmp_path / "bad.jsonl"
        bad.write_text(
            json.dumps({"kind": "span", "name": "s", "ts_us": 0.0, "seq": 0})
            + "\nnot json\n"
            + json.dumps({"kind": "mystery", "name": "x"})
            + "\n"
        )
        problems = telemetry.validate_jsonl(str(bad))
        assert len(problems) == 3  # span w/o dur, non-JSON, unknown kind
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert telemetry.validate_jsonl(str(empty)) == ["empty trace file"]

    def test_log_records_instant_only_when_enabled(self):
        tr = Tracer()
        tr.log("quiet", a=1)
        assert tr.events() == []
        tr.enabled = True
        tr.log("loud", a=1)
        (ev,) = tr.events()
        assert ev.kind == "instant" and ev.meta == {"a": 1}


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------


class TestMetrics:
    def test_counter_label_aggregation(self):
        reg = MetricsRegistry()
        c = reg.counter("requests_total")
        c.inc(workload="ising")
        c.inc(2, workload="ising")
        c.inc(workload="gmm")
        c.inc()  # label-less series is its own bucket
        assert c.value(workload="ising") == 3
        assert c.value(workload="gmm") == 1
        assert c.value() == 1
        snap = reg.snapshot()["requests_total"]
        assert snap["type"] == "counter"
        assert snap["values"]["workload=ising"] == 3

    def test_counter_rejects_negative(self):
        with pytest.raises(ValueError):
            MetricsRegistry().counter("c").inc(-1)

    def test_gauge_overwrites(self):
        g = MetricsRegistry().gauge("depth")
        g.set(3)
        g.set(1)
        assert g.value() == 1

    def test_histogram_buckets_and_stats(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v, workload="ising")
        stats = h.snapshot()["workload=ising"]
        assert stats["count"] == 4
        assert stats["sum"] == pytest.approx(5.555)
        assert stats["buckets"] == {
            "le_0.01": 1, "le_0.1": 1, "le_1": 1, "le_inf": 1
        }

    def test_registry_typechecks_reuse(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")

    def test_prometheus_text(self):
        reg = MetricsRegistry()
        reg.counter("req_total", "requests").inc(2, workload="ising")
        reg.histogram("lat_s", buckets=(0.1, 1.0)).observe(0.05)
        text = reg.prometheus_text()
        assert '# TYPE req_total counter' in text
        assert 'req_total{workload="ising"} 2' in text
        # cumulative le buckets + sum/count series
        assert 'lat_s_bucket{le="0.1"} 1' in text
        assert 'lat_s_bucket{le="+Inf"} 1' in text
        assert 'lat_s_count 1' in text

    def test_flush_jsonl_appends_snapshots(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("n").inc()
        path = str(tmp_path / "metrics.jsonl")
        reg.flush_jsonl(path)
        reg.counter("n").inc()
        reg.flush_jsonl(path)
        lines = [json.loads(line) for line in open(path)]
        assert len(lines) == 2
        assert lines[0]["metrics"]["n"]["values"][""] == 1
        assert lines[1]["metrics"]["n"]["values"][""] == 2

    def test_jsonl_flusher_rate_limits(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("n").inc()
        path = str(tmp_path / "m.jsonl")
        fl = telemetry.JsonlFlusher(reg, path, interval_s=3600.0)
        assert fl.maybe_flush() is True
        assert fl.maybe_flush() is False  # within the interval
        fl.close()  # final snapshot is unconditional
        assert len(open(path).readlines()) == 2


# --------------------------------------------------------------------------
# health monitor
# --------------------------------------------------------------------------


class TestHealth:
    def test_acceptance_collapse_warns(self):
        mon = telemetry.HealthMonitor()
        with pytest.warns(telemetry.SamplerHealthWarning, match="collapse"):
            alerts = mon.check_acceptance(0.0, where="ising")
        assert [a.kind for a in alerts] == ["acceptance_collapse"]
        assert alerts[0].severity == "critical"
        assert alerts[0].data["rate"] == 0.0
        assert mon.alerts == alerts

    def test_healthy_rate_is_silent(self):
        mon = telemetry.HealthMonitor()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mon.check_acceptance(0.3) == []

    def test_acceptance_saturation_threshold(self):
        mon = telemetry.HealthMonitor(
            telemetry.HealthThresholds(max_acceptance=0.99), warn=False
        )
        assert [a.kind for a in mon.check_acceptance(0.999)] == [
            "acceptance_saturated"
        ]

    def test_rhat_divergence_from_dict_and_nonfinite(self):
        mon = telemetry.HealthMonitor(warn=False)
        assert mon.check_chain_stats({"split_rhat": 1.01}) == []
        (a,) = mon.check_chain_stats({"split_rhat": 2.5}, where="gmm")
        assert a.kind == "rhat_divergence" and "gmm" in a.message
        (b,) = mon.check_chain_stats({"split_rhat": float("nan")})
        assert b.kind == "rhat_divergence"

    def test_swap_bottleneck_and_stalled_walkers(self):
        stats = SwapStats(3, ())
        attempted = np.array([True, False])
        rejected = np.zeros((2,), bool)
        for _ in range(10):  # ≥ stall_events rejected swap events
            stats.record(attempted, rejected)
        mon = telemetry.HealthMonitor(warn=False)
        kinds = [a.kind for a in mon.check_swap_stats(stats)]
        assert kinds == ["swap_bottleneck", "stalled_walkers"]
        pair0 = mon.alerts[0]
        assert pair0.data["pair"] == 0 and pair0.data["rate"] == 0.0

    def test_untried_pair_is_not_a_bottleneck(self):
        stats = SwapStats(3, ())  # no events at all: rates are NaN
        mon = telemetry.HealthMonitor(warn=False)
        assert mon.check_swap_stats(stats) == []

    def test_serving_slo_breaches(self):
        mon = telemetry.HealthMonitor(
            telemetry.HealthThresholds(
                p99_latency_slo_s=1.0, max_wait_slo_s=0.5
            ),
            warn=False,
        )
        summary = {"p99_latency_s": 2.0, "p99_wait_s": 0.7}
        kinds = [a.kind for a in mon.check_serving(summary)]
        assert kinds == ["latency_slo_breach", "wait_slo_breach"]
        assert mon.alerts[0].severity == "critical"
        # within SLO: silent
        assert (
            mon.check_serving({"p99_latency_s": 0.5, "p99_wait_s": 0.1}) == []
        )

    def test_alerts_counted_in_metrics(self):
        mon = telemetry.HealthMonitor(warn=False)
        mon.check_acceptance(0.0)
        c = telemetry.REGISTRY.counter("sampler_health_alerts_total")
        assert c.value(kind="acceptance_collapse") == 1


# --------------------------------------------------------------------------
# instrumented layers: bit-parity + emitted events
# --------------------------------------------------------------------------


class TestInstrumentation:
    @pytest.mark.parametrize("update", ["mh", "gibbs"])
    @pytest.mark.parametrize("execution", ["scan", "pallas"])
    def test_submit_bit_parity_tracing_on_vs_off(self, update, execution):
        """The overhead contract's numerical half: tracing never touches
        the sampled stream."""
        target, init = _gibbs_setup() if update == "gibbs" else _mh_setup()
        engine = _engine(update=update, chunk_steps=8, execution=execution, randomness="fused")
        plan = ts.RunPlan(target=target, n_steps=20, init_words=init, seed=5)
        off = engine.submit(plan).result
        tr = telemetry.enable()
        on = engine.submit(plan).result
        telemetry.disable()
        assert len([e for e in tr.events() if e.name == "engine.submit"]) == 1
        for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
            assert torch.equal(getattr(off, f), getattr(on, f)), f

    def test_submit_span_carries_plan_metadata(self):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=12, init_words=init, seed=2, step0=3)
        tr = telemetry.enable()
        engine.submit(plan)
        engine.submit(plan)
        spans = [e for e in tr.events() if e.name == "engine.submit"]
        assert len(spans) == 2
        meta = spans[0].meta
        assert meta == dict(update="mh", randomness="cim", execution="auto", n_steps=12,
                            step0=3, collect="all", num_chains=1, compiled=False)

    def test_submit_span_never_synchronises(self, monkeypatch):
        """A traced submit makes no call that waits for the card."""
        def refuse(*args, **kwargs):
            raise AssertionError("telemetry waited for the card")

        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        target, init = _mh_setup()
        tr = telemetry.enable()
        _engine(randomness="fused", execution="pallas").submit(
            ts.RunPlan(target=target, n_steps=6, init_words=init, seed=1))
        assert [e.name for e in tr.events()] == ["engine.submit"]

    def test_disabled_submit_records_nothing(self):
        target, init = _mh_setup()
        _engine().submit(ts.RunPlan(target=target, n_steps=4, init_words=init, seed=1))
        assert telemetry.TRACER.events() == []

    def test_run_resumable_emits_segment_logs(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=16, init_words=init, seed=7)
        tr = telemetry.enable()
        run_resumable(engine, plan, directory=str(tmp_path), every=8)
        segs = [e for e in tr.events() if e.name == "run_resumable.segment"]
        assert len(segs) == 2
        assert [e.meta["segment"] for e in segs] == [0, 1]
        assert [e.meta["done"] for e in segs] == [8, 16]
        for e in segs:
            assert e.meta["bytes"] > 0
            assert len(e.meta["fingerprint"]) == 12  # sha256 digest prefix
        saves = [e for e in tr.events() if e.name == "checkpoint.save"]
        assert len(saves) == 2 and all(e.meta["bytes"] > 0 for e in saves)
        assert telemetry.REGISTRY.counter("checkpoint_saves_total").value() == 2
        assert telemetry.REGISTRY.counter("resume_segments_total").value() == 2
        assert len([e for e in tr.events() if e.name == "engine.submit"]) == 2

    def test_run_resumable_restore_log_and_parity(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=16, init_words=init, seed=7)
        want = engine.submit(plan).result

        def die_once(done, total, handle):
            if done == 8:
                raise RuntimeError("preempted")

        with pytest.raises(RuntimeError):
            run_resumable(engine, plan, directory=str(tmp_path), every=8, on_segment=die_once)
        tr = telemetry.enable()
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        restores = [e for e in tr.events() if e.name == "run_resumable.restore"]
        assert len(restores) == 1 and restores[0].meta["done"] == 8
        assert torch.equal(handle.result.final_words, want.final_words)
        assert torch.equal(handle.result.samples, want.samples)

    def test_handle_save_logs(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine()
        plan = ts.RunPlan(target=target, n_steps=4, init_words=init, seed=3)
        handle = engine.submit(plan)
        tr = telemetry.enable()
        path = handle.save(str(tmp_path))
        names = [e.name for e in tr.events()]
        assert names == ["checkpoint.save", "checkpoint.saved", "checkpoint.handle_save",
                         "run_handle.save"]
        (log,) = [e for e in tr.events() if e.name == "run_handle.save"]
        assert log.meta["path"] == path and log.meta["step"] == 4
        assert log.meta["fingerprint"] == ts.plan.fingerprint_digest(plan.fingerprint(engine))

    def test_exported_trace_validates(self, tmp_path):
        target, init = _mh_setup()
        tr = telemetry.enable()
        run_resumable(_engine(chunk_steps=4), ts.RunPlan(target=target, n_steps=8,
                                                         init_words=init, seed=1),
                      directory=str(tmp_path / "ckpt"), every=4)
        path = str(tmp_path / "run.trace.jsonl")
        assert tr.export(path) == len(tr.events())
        assert telemetry.validate_jsonl(path) == []
        assert jax_telemetry.validate_jsonl(path) == []  # the JAX checker reads it too
