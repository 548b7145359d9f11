"""The port's autotuner and ``run_engine`` shim against the JAX package's
(``tests/test_run_plan.py:TestAutotune``), on the CPU.

The tuner's protocol (incumbent first, argmax winner, one measurement a
shape, a cache hit after), its key and cache schema are held against the
JAX package's; a tuned engine's stream equals the incumbent's and the
JAX package's tuned engine at tolerance 0 on the same table (carried
across as float32), whose draws are asserted free of tie events.  The
``block_c`` axis is not a knob of the port: its grid collapses to the
incumbent's ``block_c``.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro_torch import prng, telemetry
from repro_torch import samplers as ts
from repro_torch.kernels.mh import ref as mref
from repro_torch.samplers import autotune

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)
B, V, C, SEED, N = 2, 64, 8, 11, 24
TUNE = dict(n_steps=16, repeats=1)


def _table(b=B, v=V):
    return (np.random.default_rng(3).normal(size=(b, v)) * 2).astype(np.float32)


def _setups(c=C):
    """((port target, init), (JAX target, init)) on the same table."""
    table = _table()
    init = np.broadcast_to(table.argmax(-1).astype(np.uint32)[:, None], (B, c)).copy()
    port = (ts.TableTarget(torch.from_numpy(table)), torch.from_numpy(init.astype(np.int64)))
    return port, (js.TableTarget(jnp.asarray(table)), jnp.asarray(init))


def _cfg(pkg, **kw):
    return pkg.EngineConfig(**{"chunk_steps": 32, "execution": "scan", **kw})


def test_measured_then_cached_never_slower(tmp_path):
    (target, init), _ = _setups(c=16)
    cfg = _cfg(ts)
    cache = str(tmp_path / "autotune.json")
    tuned_cfg, res = ts.autotune_config(cfg, target, init, chunk_candidates=(16, 64),
                                        cache_path=cache, device="cpu", **TUNE)
    assert res.source == "measured"
    assert res.candidates[0][:3] == (32, cfg.block_c, "scan")  # the incumbent first
    assert res.steps_per_s >= res.baseline_steps_per_s
    assert res.steps_per_s == max(c[3] for c in res.candidates)  # the argmax wins
    winner = next(c for c in res.candidates if c[3] == res.steps_per_s)
    assert winner[:3] == (res.chunk_steps, res.block_c, res.execution)
    assert tuned_cfg.chunk_steps == res.chunk_steps
    tuned2, res2 = ts.autotune_config(cfg, target, init, chunk_candidates=(16, 64),
                                      cache_path=cache, device="cpu", **TUNE)
    assert res2.source == "cache"
    assert tuned2 == tuned_cfg
    assert res2.candidates == tuple(tuple(c) for c in res.candidates)


def test_refresh_measures_again(tmp_path):
    (target, init), _ = _setups()
    cache = str(tmp_path / "c.json")
    kw = dict(chunk_candidates=(8,), cache_path=cache, device="cpu", **TUNE)
    ts.autotune_config(_cfg(ts), target, init, **kw)
    _, res = ts.autotune_config(_cfg(ts), target, init, refresh=True, **kw)
    assert res.source == "measured"


def test_cache_key_separates_shapes_and_matches_jax():
    (target, init), (jtarget, jinit) = _setups()
    k1 = autotune.tune_key(_cfg(ts), target, init, device="cpu")
    assert k1 != autotune.tune_key(_cfg(ts), target, init[:, :4], device="cpu")
    assert k1 != autotune.tune_key(_cfg(ts, randomness="fused"), target, init, device="cpu")
    # the workload and engine part of the key is the JAX package's; the
    # device part names the torch device: type, name, count
    jk = js.autotune.tune_key(_cfg(js), jtarget, jinit)
    assert k1.split("|")[:7] == jk.split("|")[:7]
    assert k1.split("|")[7:] == ["cpu", "cpu", "D1"]


def test_cache_schema_equals_jax(tmp_path):
    (target, init), (jtarget, jinit) = _setups()
    kw = dict(chunk_candidates=(8, 16), **TUNE)
    ts.autotune_config(_cfg(ts, randomness="fused"), target, init,
                       cache_path=str(tmp_path / "t.json"), device="cpu", **kw)
    js.autotune_config(_cfg(js, randomness="fused"), jtarget, jinit,
                       cache_path=str(tmp_path / "j.json"), **kw)
    (tentry,) = json.loads((tmp_path / "t.json").read_text()).values()
    (jentry,) = json.loads((tmp_path / "j.json").read_text()).values()
    assert sorted(tentry) == sorted(jentry)
    for k in tentry:
        assert type(tentry[k]) is type(jentry[k]), k
    assert tentry["version"] == jentry["version"]
    assert [c[:3] for c in tentry["candidates"]] == [c[:3] for c in jentry["candidates"]]


def test_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.delenv(js.autotune.CACHE_ENV, raising=False)
    path = autotune.default_cache_path()
    assert path.endswith(os.path.join(".cache", "repro_torch", "autotune.json"))
    assert path != js.autotune.default_cache_path()
    assert autotune.CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"
    monkeypatch.setenv(autotune.CACHE_ENV, "/x/tune.json")
    monkeypatch.setenv(js.autotune.CACHE_ENV, "/y/tune.json")
    assert autotune.default_cache_path() == "/x/tune.json"


def test_block_c_grid_collapses_to_the_incumbent(tmp_path):
    """Under pallas the JAX grid crosses chunks with ``block_c``
    candidates; the port's CUDA kernel picks its own chain tile, so every
    candidate keeps the incumbent's ``block_c``."""
    (target, init), _ = _setups()
    cfg = _cfg(ts, execution="pallas", block_c=128)
    tuned, res = ts.autotune_config(cfg, target, init, chunk_candidates=(8, 16),
                                    block_c_candidates=(128, 256, 512),
                                    cache_path=str(tmp_path / "c.json"), device="cpu", **TUNE)
    assert [c[:3] for c in res.candidates] == [(32, 128, "pallas"), (8, 128, "pallas"),
                                               (16, 128, "pallas")]
    assert tuned.block_c == 128 == res.block_c


def test_auto_grid_holds_both_executors(tmp_path):
    (target, init), _ = _setups()
    cfg = _cfg(ts, execution="auto")
    _, res = ts.autotune_config(cfg, target, init, chunk_candidates=(8,),
                                cache_path=str(tmp_path / "c.json"), device="cpu", **TUNE)
    # auto is scan on the CPU; pallas is eligible on a table target
    assert [c[:3] for c in res.candidates] == [(32, 256, "scan"), (8, 256, "scan"),
                                               (8, 256, "pallas")]


def test_incumbent_must_run(tmp_path):
    """A pallas incumbent on a target the kernels cannot take raises: no
    fallback."""
    target = ts.CallableTarget(lambda w: -(w.to(torch.float32) - 3.0) ** 2, nbits=4)
    with pytest.raises(ValueError, match="table target"):
        ts.autotune_config(_cfg(ts, execution="pallas"), target, torch.zeros(2, 4),
                           cache_path=str(tmp_path / "c.json"), device="cpu", **TUNE)


def _failing_pallas(monkeypatch, error):
    """``measure_config`` with every pallas candidate raising ``error``."""
    measure = autotune.measure_config

    def fake(cfg, *args, **kw):
        if cfg.execution == "pallas":
            raise error
        return measure(cfg, *args, **kw)

    monkeypatch.setattr(autotune, "measure_config", fake)


def test_ineligible_candidate_is_dropped(tmp_path, monkeypatch):
    """An engine's ``ValueError`` marks a candidate ineligible: the tuner
    drops it and keeps measuring."""
    (target, init), _ = _setups()
    _failing_pallas(monkeypatch, ValueError("ineligible shape"))
    _, res = ts.autotune_config(_cfg(ts, execution="auto"), target, init,
                                chunk_candidates=(8,), cache_path=str(tmp_path / "c.json"),
                                device="cpu", **TUNE)
    assert [c[:3] for c in res.candidates] == [(32, 256, "scan"), (8, 256, "scan")]


def test_kernel_failure_is_raised(tmp_path, monkeypatch):
    """A kernel that does not build or launch (``RuntimeError``) is no
    ineligible shape: the tuner raises it, and caches nothing, rather
    than keep the plain version."""
    (target, init), _ = _setups()
    cache = tmp_path / "c.json"
    _failing_pallas(monkeypatch, RuntimeError("nvcc failed"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ts.autotune_config(_cfg(ts, execution="auto"), target, init, chunk_candidates=(8,),
                           cache_path=str(cache), device="cpu", **TUNE)
    assert not cache.exists()


def test_tuner_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (target, init), _ = _setups()
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.autotune_config(_cfg(ts), target, init, cache_path=str(tmp_path / "c.json"))


def test_measure_spans_and_result_log(tmp_path):
    (target, init), _ = _setups()
    tr = telemetry.enable()
    try:
        ts.autotune_config(_cfg(ts), target, init, chunk_candidates=(8, 16),
                           cache_path=str(tmp_path / "c.json"), device="cpu", **TUNE)
        events = tr.events()
    finally:
        telemetry.disable()
    spans = [e for e in events if e.name == "autotune.measure"]
    assert [e.meta["incumbent"] for e in spans] == [True, False, False]
    assert all(e.meta["outcome"] == "ok" for e in spans)
    assert any(e.name == "autotune.result" for e in events)


def _assert_no_ties(target, init, randomness, n_steps):
    backend = ts.EngineConfig(randomness=randomness).backend()
    flips, u = backend.chunk(ts.chain_key(prng.PRNGKey(SEED), 0), 0, n_steps,
                             tuple(init.shape), target.nbits)
    ties = mref.tie_events(target.table, init, flips, u, target.nbits)
    assert ties.shape[0] == 0, f"tie events {ties[:4].tolist()}"


@partitionable
@pytest.mark.parametrize("randomness", ["cim", "fused"])
def test_tuned_stream_equals_incumbent_and_jax(tmp_path, randomness):
    """chunk_steps/execution tuning never changes the stream: the tuned
    engine equals the incumbent, and the JAX package's tuned engine (its
    grid pinned to scan: the JAX package holds its executors equal, and
    its pallas candidates run in interpret mode here)."""
    (target, init), (jtarget, jinit) = _setups()
    _assert_no_ties(target, init, randomness, N)
    kw = dict(chunk_candidates=(8,), **TUNE)
    base = ts.MHEngine(_cfg(ts, randomness=randomness, execution="auto"), device="cpu")
    tuned, res = ts.autotune_engine(base, target, init, cache_path=str(tmp_path / "t.json"), **kw)
    assert tuned.device == base.device and res.source == "measured"
    jbase = js.MHEngine(_cfg(js, randomness=randomness))
    jtuned, _ = js.autotune_engine(jbase, jtarget, jinit, cache_path=str(tmp_path / "j.json"),
                                   **kw)
    key = prng.PRNGKey(SEED)
    a = base.run(key, target, N, init)
    b = tuned.run(key, target, N, init)
    j = jtuned.run(jax.random.PRNGKey(SEED), jtarget, N, jinit)
    for f in ("samples", "final_words", "accept_count", "final_logp"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(j, f)).astype(getattr(b, f).numpy().dtype),
                                      err_msg=f)


@partitionable
def test_run_engine_warns_and_equals_submit_and_jax():
    (target, init), (jtarget, jinit) = _setups()
    _assert_no_ties(target, init, "cim", N)
    engine = ts.MHEngine(_cfg(ts, chunk_steps=8), device="cpu")
    with pytest.warns(DeprecationWarning, match="RunPlan"):
        res = ts.run_engine(prng.PRNGKey(SEED), init, engine=engine, target=target, n_steps=N,
                            step0=3, collect="thin:2")
    want = engine.submit(ts.RunPlan(target=target, n_steps=N, init_words=init,
                                    key=prng.PRNGKey(SEED), step0=3, collect="thin:2")).result
    jengine = js.MHEngine(_cfg(js, chunk_steps=8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = js.engine.run_engine(jax.random.PRNGKey(SEED), jinit, engine=jengine,
                                    target=jtarget, n_steps=N, step0=3, collect="thin:2")
    for f in ("samples", "final_words", "accept_count", "final_logp"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)).astype(
                                          getattr(res, f).numpy().dtype), err_msg=f)


def test_samplers_exports():
    for name in ("TuneResult", "autotune_config", "autotune_engine", "run_engine"):
        assert name in ts.__all__ and hasattr(ts, name)
    assert ts.autotune is autotune
