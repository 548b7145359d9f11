"""``submit(compiled=True)``: the port's compiled entry against the JAX
package's, on the CPU.

On the card the port captures a CUDA graph once per signature and
replays it; on the CPU there is no graph, and ``compiled=True`` runs the
direct path while the cache keeps the signatures.  So here the
``jit_cache`` verdicts of a sequence of submits are held against the
JAX package's jitted dispatcher submit for submit, and the results of
``compiled=True`` against JAX's ``compiled=True`` and the port's direct
path under the parity contract: integers bit for bit, the MH log-probs
(table lookups) bit for bit, the Gibbs per-site log-probs within 4 ULP.
The data are ``test_torch_engine.py``'s and ``test_torch_workloads.py``'s
sizes, and each case first asserts that its operands hold no tie event
(the contract's only exception).  The card's side (replays bit for bit,
results that survive later replays, freed graphs) is in
``test_torch_gpu.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro import telemetry as jax_telemetry
from repro.workloads import ising as jising
from repro_torch import convert, prng, telemetry
from repro_torch import samplers as ts
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import ref

B, V, C, N = 2, 45, 4, 13
SEED = 17
H, W = 8, 8
# JAX's chunks, by backend: those it compiles fastest (a stream never
# depends on its chunking); the port runs chunks of 5
JAX_CHUNK = {"host": 64, "cim": 5, "fused": 64}

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


@pytest.fixture(autouse=True)
def _telemetry_off():
    yield
    telemetry.disable()
    telemetry.TRACER.reset()
    jax_telemetry.disable()


def _data():
    rs = np.random.default_rng(SEED)
    table = (rs.normal(size=(B, V)) * 2).astype(np.float32)
    init = rs.integers(0, V, size=(2, B, C)).astype(np.uint32)
    return table, init


def _assert_no_mh_ties(randomness, chains):
    """The port's operands of each chain hold no tie event."""
    table, init = _data()
    backend = ts.EngineConfig(randomness=randomness, p_bfr=0.4).backend()
    keys = ts.chain_keys(prng.PRNGKey(SEED), chains)
    nbits = ts.TableTarget(torch.from_numpy(table)).nbits
    for c in range(chains):
        flips, u = backend.chunk(keys[c], 0, N, (B, C), nbits)
        ties = ref.tie_events(torch.from_numpy(table),
                              torch.from_numpy(init[c].astype(np.int64)), flips, u, nbits)
        assert ties.shape[0] == 0, f"tie events {ties.tolist()} in chain {c}"


# --- the jit_cache verdicts ----------------------------------------------------------


def _verdicts(side):
    """One sequence of compiled submits on ``side`` ("jax" or "port"):
    the ``jit_cache`` verdict of each, in order."""
    table, init = _data()
    if side == "jax":
        mod, tel = js, jax_telemetry

        def engine(**kw):
            return js.MHEngine(js.EngineConfig(**kw))

        def target():
            return js.TableTarget(table)
    else:
        mod, tel = ts, telemetry

        def engine(**kw):
            return ts.MHEngine(ts.EngineConfig(**kw), device="cpu")

        def target():
            return ts.TableTarget(torch.from_numpy(table))

    # one chunk of few fused steps: each JAX miss compiles in about a second
    cfg = dict(randomness="fused", p_bfr=0.4, chunk_steps=64, execution="scan")
    eng, tgt = engine(**cfg), target()
    plan = mod.RunPlan(target=tgt, n_steps=4, init_words=init[0], seed=3)
    eng2 = engine(**cfg, num_chains=2)
    plan2 = plan.replace(init_words=init)
    steps = [
        (eng, plan),                              # miss
        (eng, plan),                              # hit: the same plan
        (eng, plan.replace(seed=4)),              # hit: another key, the same signature
        (eng, plan.replace(n_steps=3)),           # miss: a new n_steps
        (eng, plan),                              # hit: back to the first
        (eng, plan.replace(step0=5)),             # miss: a new step0
        (eng, plan.replace(collect="thin:3")),    # miss: a new collect
        (eng, plan.replace(target=target())),     # miss: a new target object
        (engine(**cfg), plan),                    # miss: a new engine
        (eng2, plan2),                            # miss: a num_chains = 2 config
        (eng2, plan2.replace(seed=9)),            # hit
    ]
    tr = tel.enable()
    for e, p in steps:
        e.submit(p, compiled=True)
    verdicts = [ev.meta.get("jit_cache") for ev in tr.events() if ev.name == "engine.submit"]
    tel.disable()
    return verdicts


@partitionable
def test_jit_cache_verdicts_equal_jax():
    want = _verdicts("jax")
    assert want == ["miss", "hit", "hit", "miss", "hit", "miss", "miss", "miss", "miss",
                    "miss", "hit"]
    assert _verdicts("port") == want


def test_tensor_step0_takes_the_direct_path():
    """A 0-d tensor ``step0`` is the port's traced offset: it takes the
    direct path, records no verdict and caches nothing, and runs the
    stream of the int offset."""
    table, init = _data()
    eng = ts.MHEngine(ts.EngineConfig(randomness="fused", chunk_steps=5), device="cpu")
    plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
                      init_words=init[0], seed=3, step0=torch.tensor(7))
    tr = telemetry.enable()
    got = eng.submit(plan, compiled=True).result
    (span,) = [e for e in tr.events() if e.name == "engine.submit"]
    assert "jit_cache" not in span.meta and span.meta["compiled"] is True
    assert span.meta["step0"] is None  # JAX's span for a traced offset
    assert eng._compiled == {}
    want = eng.submit(plan.replace(step0=7)).result
    for f in ("samples", "accept_count", "final_words", "final_logp"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_tensor_step0_has_no_host_progress():
    """``concrete_step0`` and ``RunHandle.progress`` read ``step0`` on the
    host, so a tensor one raises there (JAX's traced offset); an int one
    gives the ints."""
    table, init = _data()
    eng = ts.MHEngine(ts.EngineConfig(randomness="host", chunk_steps=5), device="cpu")
    plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
                      init_words=init[0], seed=3, step0=torch.tensor(7))
    handle = eng.submit(plan)
    with pytest.raises(ValueError, match="tensor step0"):
        plan.concrete_step0
    with pytest.raises(ValueError, match="tensor step0"):
        handle.progress
    with pytest.raises(ValueError, match="tensor step0"):
        handle.resume_plan(3)
    assert plan.replace(step0=7).concrete_step0 == 7
    assert eng.submit(plan.replace(step0=7)).progress == 7 + N
    with pytest.raises(ValueError, match=">= 0"):
        plan.replace(step0=-1)


# --- results against JAX's compiled entry --------------------------------------------


@pytest.fixture(scope="module")
def jax_compiled():
    """JAX's ``submit(compiled=True)`` results, by case, made once."""
    runs = {}

    def get(case, make):
        if case not in runs:
            res = make().result
            runs[case] = {f: np.asarray(getattr(res, f)) for f in
                          ("samples", "accept_count", "final_words", "final_logp")}
        return runs[case]

    return get


def _kept(run, collect):
    """JAX's kept set of ``collect`` from its ``"all"`` run (step0 = 0):
    ``thin:k`` keeps the steps t % k == 0, ``last`` the final carry only."""
    mode, k = js.parse_collect(collect)
    keep = {"all": slice(None), "thin": slice(0, None, k), "last": slice(0, 0)}[mode]
    return dict(run, samples=run["samples"][keep])


def _hold(port_direct, port_compiled, want, logp_ulps=0):
    for f in ("samples", "accept_count", "final_words"):
        np.testing.assert_array_equal(getattr(port_compiled, f).numpy(), want[f], err_msg=f)
    got = port_compiled.final_logp.numpy()
    if logp_ulps:
        np.testing.assert_allclose(got, want["final_logp"], rtol=logp_ulps * 2.0**-23, atol=0)
    else:
        np.testing.assert_array_equal(got, want["final_logp"])
    for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
        assert torch.equal(getattr(port_compiled, f), getattr(port_direct, f)), f


def _port_runs(cfg, plan):
    eng = ts.MHEngine(ts.EngineConfig(**cfg), device="cpu")
    return eng.submit(plan).result, eng.submit(plan, compiled=True).result


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("collect", ["all", "last", "thin:3"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_compiled_mh_equals_jax(jax_compiled, randomness, collect, execution):
    """The port's compiled ``collect`` runs against JAX's compiled ``all``
    run through JAX's collect contract (one JAX compile a backend)."""
    _assert_no_mh_ties(randomness, 1)
    table, init = _data()
    want = _kept(jax_compiled(("mh", randomness), lambda: js.MHEngine(js.EngineConfig(
        randomness=randomness, p_bfr=0.4, chunk_steps=JAX_CHUNK[randomness],
        execution="scan")).submit(
        js.RunPlan(target=js.TableTarget(table), n_steps=N, init_words=init[0], seed=SEED,
                   collect="all"), compiled=True)), collect)
    plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
                      init_words=init[0], seed=SEED, collect=collect)
    _hold(*_port_runs(dict(randomness=randomness, p_bfr=0.4, chunk_steps=5,
                           execution=execution), plan), want)


@partitionable
def test_compiled_init_logp_equals_jax(jax_compiled):
    """The solo MH scan carry: ``init_logp`` through JAX's second
    dispatcher and through the port's signature with it present."""
    _assert_no_mh_ties("host", 1)
    table, init = _data()
    logp = np.take_along_axis(table, init[0].astype(np.int64), axis=1)
    want = jax_compiled("init_logp", lambda: js.MHEngine(js.EngineConfig(
        randomness="host", p_bfr=0.4, chunk_steps=JAX_CHUNK["host"], execution="scan")).submit(
        js.RunPlan(target=js.TableTarget(table), n_steps=N, init_words=init[0], seed=SEED,
                   init_logp=logp), compiled=True))
    plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
                      init_words=init[0], seed=SEED, init_logp=logp)
    _hold(*_port_runs(dict(randomness="host", p_bfr=0.4, chunk_steps=5, execution="scan"),
                      plan), want)


@partitionable
@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_compiled_two_chains_equal_jax(jax_compiled, execution):
    _assert_no_mh_ties("fused", 2)
    table, init = _data()
    want = jax_compiled("chains", lambda: js.MHEngine(js.EngineConfig(
        randomness="fused", p_bfr=0.4, chunk_steps=JAX_CHUNK["fused"], execution="scan",
        num_chains=2)).submit(
        js.RunPlan(target=js.TableTarget(table), n_steps=N, init_words=init, seed=SEED),
        compiled=True))
    plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
                      init_words=init, seed=SEED)
    _hold(*_port_runs(dict(randomness="fused", p_bfr=0.4, chunk_steps=5, execution=execution,
                           num_chains=2), plan), want)


@partitionable
@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_compiled_gibbs_fused_equals_jax(jax_compiled, execution):
    jm = jising.IsingModel(H, W, beta=0.4407, field=0.05)
    model = convert.ising_from_jax(jm)
    init = np.random.default_rng([SEED, H]).integers(0, 2, size=(B, H, W)).astype(np.uint32)
    backend = ts.EngineConfig(update="gibbs", randomness="fused").backend()
    _, u = backend.chunk(ts.chain_key(prng.PRNGKey(SEED), 0), 0, N, (B, H, W), 1,
                         need_flips=False)
    ties = gref.chain_ties(torch.from_numpy(init.astype(np.int64)), u, model.logit_spec, 0)
    assert ties.shape[0] == 0, f"tie events {ties.tolist()}"
    want = jax_compiled("gibbs", lambda: js.MHEngine(js.EngineConfig(
        update="gibbs", randomness="fused", chunk_steps=5, collect="thin:3")).submit(
        js.RunPlan(target=jm, n_steps=N, init_words=init, seed=SEED), compiled=True))
    plan = ts.RunPlan(target=model, n_steps=N, init_words=init, seed=SEED)
    _hold(*_port_runs(dict(update="gibbs", randomness="fused", chunk_steps=5,
                           collect="thin:3", execution=execution), plan), want, logp_ulps=4)
