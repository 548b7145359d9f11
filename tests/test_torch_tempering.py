"""The port's tempering package against the JAX package's
(``tests/test_tempering.py`` and its contracts).

Inputs are made from numpy seeds and handed to both packages: a (2, 64)
log-prob table with 8 chains a row, a 6 x 6 Ising lattice and a 4 x 4
±1 spin glass, B = 2 lattices.  Held at tolerance 0:

  * ``Ladder``/``Annealer`` schedules, the scaled table
    (``float32(beta) * table``) and the tempered conditional logit;
  * the scaled logit spec through both Gibbs kernels' plain versions
    against JAX's Pallas kernels (interpret mode) tracing
    ``TemperedLattice``;
  * ``ReplicaExchange.run`` on the three targets under host/cim/fused x
    scan/pallas x two chunkings: samples, accept counts, final words,
    ``final_logp``, the pooled rate and every ``SwapStats`` field, each
    against one JAX run per (target, randomness) (the JAX package holds
    its own executors and chunkings equal);
  * ``Annealer.run`` against JAX's, and the port's anneal reaching the
    exhaustive ground state.

Each compared run is first replayed for tie events (``ReplicaExchange.
tie_events``; the Gibbs and MH tie helpers on every annealing stage):
the seeds are asserted free of them, the parity contract's only
exception (ROADMAP queue 3 item 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro import tempering as jt
from repro.kernels.gibbs.gibbs import gibbs_chain_pallas, gibbs_chain_pallas_fused
from repro.workloads.ising import IsingModel as JIsing
from repro.workloads.spin_glass import SpinGlass as JGlass
from repro_torch import convert, prng, tempering
from repro_torch import samplers as ts
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import ref as mref
from repro_torch.workloads.spin_glass import SpinGlass, exhaustive_ground_state

R, N, SWAP, KEY = 3, 18, 6, 7
BETAS = (0.37, 2.5)

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _targets(kind):
    """(JAX target, port target, init (B, ...) uint32) from a numpy seed."""
    rs = np.random.default_rng([3, len(kind)])
    if kind == "table":
        table = rs.normal(size=(2, 64)).astype(np.float32) * 2
        table[1, 60:] = -np.inf
        init = np.broadcast_to(table.argmax(-1).astype(np.uint32)[:, None], (2, 8))
        return (js.TableTarget(jnp.asarray(table)),
                convert.table_target_from_numpy(table, device="cpu"), init)
    init = rs.integers(0, 2, size=(2, 6, 6) if kind == "ising" else (2, 4, 4)).astype(np.uint32)
    if kind == "ising":
        jm = JIsing(6, 6, beta=0.4407, field=0.05)
        return jm, convert.ising_from_jax(jm), init
    jr, jd = (rs.choice([-1.0, 1.0], size=(4, 4)).astype(np.float32) for _ in range(2))
    return (JGlass(jr, jd, field=-0.2),
            SpinGlass(*convert.couplings_from_numpy(jr, jd, device="cpu"), field=-0.2), init)


def _update(kind):
    return "mh" if kind == "table" else "gibbs"


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


# --- schedules and scaled targets ----------------------------------------


@pytest.mark.parametrize("n,lo,hi", [(1, 0.25, 1.0), (4, 0.25, 1.0), (8, 0.25, 1.0),
                                     (5, 0.3, 0.9)])
def test_schedules_equal_jax(n, lo, hi):
    for kind in ("geometric", "linear"):
        assert getattr(tempering.Ladder, kind)(n, lo, hi) == \
            tempering.Ladder(getattr(jt.Ladder, kind)(n, lo, hi).betas)
        want = getattr(jt.Annealer, kind)(n, 16, lo, 4 * hi)
        got = getattr(tempering.Annealer, kind)(n, 16, lo, 4 * hi)
        assert (got.betas, got.steps_per_beta, got.n_steps) == \
            (want.betas, want.steps_per_beta, want.n_steps)


def test_validation():
    with pytest.raises(ValueError, match="non-increasing"):
        tempering.Ladder((0.5, 1.0))
    with pytest.raises(ValueError, match="finite"):
        tempering.Ladder((1.0, 0.0))
    with pytest.raises(ValueError, match="non-decreasing"):
        tempering.Annealer((2.0, 1.0), 4)
    with pytest.raises(ValueError, match="finite"):
        tempering.scaled_target(_targets("table")[1], float("nan"))
    _, target, init = _targets("table")
    eng = ts.MHEngine(ts.EngineConfig(), device="cpu")
    rex = tempering.ReplicaExchange(tempering.Ladder.geometric(3), eng)
    with pytest.raises(ValueError, match="leading"):
        rex.run(prng.PRNGKey(0), target, 8, init)
    with pytest.raises(ValueError, match="chain-id axis"):
        tempering.ReplicaExchange(tempering.Ladder.geometric(2),
                                  ts.MHEngine(ts.EngineConfig(num_chains=2), device="cpu"))
    with pytest.raises(ValueError, match="single chain"):
        tempering.Annealer((1.0,), 4).run(
            prng.PRNGKey(0), target, init,
            engine=ts.MHEngine(ts.EngineConfig(num_chains=2), device="cpu"))
    lattice = tempering.scaled_target(_targets("ising")[1], 0.5)
    with pytest.raises(ValueError, match="one scale"):
        tempering.scaled_target(lattice, 0.5).logit_spec


@pytest.mark.parametrize("beta", [0.25, 0.3, 1 / 3, 0.7071067811865476, 2.5])
def test_scaled_table_bit_equal_jax(beta):
    jtarget, target, _ = _targets("table")
    want = np.asarray(jt.scaled_target(jtarget, beta).table)
    scaled = tempering.scaled_target(target, beta)
    np.testing.assert_array_equal(scaled.table.numpy(), want)
    assert scaled.nbits == target.nbits
    assert tempering.scaled_target(target, 1.0) is target
    # a top-k table keeps its base's decode
    logits = np.random.default_rng(2).normal(size=(2, 50)).astype(np.float32)
    topk = ts.TopKTarget(torch.from_numpy(logits), 8)
    words = torch.tensor([[0, 7], [3, 1]])
    assert torch.equal(tempering.scaled_target(topk, beta).decode(words), topk.decode(words))
    # a callable target: float32(beta) * log_prob
    jcall = js.CallableTarget(lambda w: -0.3 * w.astype(jnp.float32), 6)
    call = ts.CallableTarget(lambda w: -0.3 * w.to(torch.float32), 6)
    w = np.arange(64, dtype=np.uint32)
    np.testing.assert_array_equal(
        tempering.scaled_target(call, beta).log_prob(_t(w)).numpy(),
        np.asarray(jt.scaled_target(jcall, beta).log_prob(jnp.asarray(w))))


@pytest.mark.parametrize("kind", ["ising", "spin_glass"])
@pytest.mark.parametrize("beta", [0.37, 0.8408964152537145, 2.5])
def test_tempered_lattice_equals_jax(kind, beta):
    jm, model, init = _targets(kind)
    states = np.random.default_rng(5).integers(0, 2, size=(6, *init.shape[1:])).astype(np.uint32)
    jtemp, temp = jt.scaled_target(jm, beta), tempering.scaled_target(model, beta)
    np.testing.assert_array_equal(
        temp.conditional_logit(_t(states)).numpy(),
        np.asarray(jax.jit(jtemp.conditional_logit)(jnp.asarray(states))))
    assert temp.logit_spec.scale == float(np.float32(beta))
    assert temp.supports_fused_gibbs and temp.nbits == 1 and temp.table is None
    # the beta = 1 statistics delegate to the base model
    np.testing.assert_array_equal(temp.energy(_t(states)).numpy(),
                                  np.asarray(jtemp.energy(jnp.asarray(states))))
    assert torch.equal(temp.update_mask((6, 4), 1), model.update_mask((6, 4), 1))


def _jax_logit(jm, beta):
    """The closure and consts JAX's engine hands its Pallas kernels."""
    temp = jt.scaled_target(jm, beta)
    consts = tuple(getattr(temp, "fused_consts", ()) or ())
    return (temp.fused_logit if consts else temp.conditional_logit), consts


@pytest.mark.parametrize("kind", ["ising", "spin_glass"])
@pytest.mark.parametrize("beta", BETAS)
def test_scaled_kernels_plain_versions_equal_jax_pallas(kind, beta):
    jm, model, init = _targets(kind)
    spec = tempering.scaled_target(model, beta).logit_spec
    fn, consts = _jax_logit(jm, beta)
    rs = np.random.default_rng([int(beta * 100), len(kind)])
    k = 12
    u = rs.random(size=(k, *init.shape), dtype=np.float32)
    parity0 = np.array([1, 0], np.int32)
    want = gibbs_chain_pallas(jnp.asarray(init), jnp.asarray(u), fn,
                              parity0=jnp.asarray(parity0), interpret=True, consts=consts)
    assert gref.chain_ties(_t(init), torch.from_numpy(u), spec, _t(parity0)).shape[0] == 0
    got = gref.gibbs_chain_ref(_t(init), torch.from_numpy(u), spec, _t(parity0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k0b, k1b = (rs.integers(0, 2**32, size=(2,), dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    t0b = np.array([5, 2**31 - 4], np.int32)
    want = gibbs_chain_pallas_fused(jnp.asarray(init), jnp.asarray(k0b), jnp.asarray(k1b),
                                    jnp.asarray(t0b), fn, n_steps=k, lat_b=2, interpret=True,
                                    consts=consts)
    u = torch.stack([gref.fused_uniforms(_t(k0b), _t(k1b), _t(t0b), j, init.shape, 2)
                     for j in range(k)])
    for i in range(2):
        assert gref.chain_ties(_t(init[i:i + 1]), u[:, i:i + 1], spec,
                               int(t0b[i]) % 2).shape[0] == 0
    got = gref.gibbs_chain_fused_ref(_t(init), _t(k0b), _t(k1b), _t(t0b), spec, k, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- replica exchange -------------------------------------------------------


SWAP_FIELDS = ("attempts", "accepts", "events", "round_trips")


@pytest.fixture(scope="module")
def jax_exchange():
    runs = {}

    def get(kind, randomness):
        if (kind, randomness) not in runs:
            jtarget, _, init = _targets(kind)
            eng = js.MHEngine(js.EngineConfig(update=_update(kind), randomness=randomness,
                                              execution="pallas", chunk_steps=1000))
            res = jt.ReplicaExchange(jt.Ladder.geometric(R, beta_min=0.3), eng,
                                     swap_every=SWAP).run(
                jax.random.PRNGKey(KEY), jtarget, N, np.broadcast_to(init, (R, *init.shape)))
            runs[kind, randomness] = res
        return runs[kind, randomness]

    return get


def _port_exchange(kind, randomness, execution, chunk):
    _, target, init = _targets(kind)
    eng = ts.MHEngine(ts.EngineConfig(update=_update(kind), randomness=randomness,
                                      execution=execution, chunk_steps=chunk), device="cpu")
    rex = tempering.ReplicaExchange(tempering.Ladder.geometric(R, beta_min=0.3), eng,
                                    swap_every=SWAP)
    return rex, target, np.broadcast_to(init, (R, *init.shape))


@partitionable
@pytest.mark.parametrize("kind", ["table", "ising", "spin_glass"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
def test_exchange_equals_jax(jax_exchange, kind, randomness):
    want = jax_exchange(kind, randomness)
    rex, target, inits = _port_exchange(kind, randomness, "scan", 1000)
    assert rex.tie_events(prng.PRNGKey(KEY), target, N, inits) == {"moves": 0, "swaps": 0}
    for execution in ("scan", "pallas"):
        for chunk in (5, 1000):
            rex, target, inits = _port_exchange(kind, randomness, execution, chunk)
            got = rex.run(prng.PRNGKey(KEY), target, N, inits)
            for f in ("samples", "accept_count", "final_words", "final_logp"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)), f)
            assert np.float32(got.acceptance_rate.item()) == np.float32(want.acceptance_rate)
            for f in SWAP_FIELDS:
                np.testing.assert_array_equal(getattr(got.swap, f), getattr(want.swap, f), f)
            assert got.swap.summary() == want.swap.summary()
            assert got.betas == want.betas and got.n_steps == want.n_steps


@partitionable
def test_scan_segments_are_jax_programs():
    """Under scan each replica's segments run through a compiled program
    keyed as JAX's jitted ``_scan_segment`` (engine, target, segment
    length, chain slot and the inputs' layouts), ``step0`` staged as a
    tensor: one program for each replica and distinct segment length, as
    many as JAX's cache holds, kept on the exchange for a rerun, and the
    run equals JAX's scan run.  A kernel engine or a thinning one submits
    directly and keeps none."""
    from repro.tempering import exchange as jexchange

    jtarget, target, init = _targets("ising")
    n, swap = 10, 6  # segments of 6 and 4 steps
    inits = np.broadcast_to(init, (2, *init.shape))
    jeng = js.MHEngine(js.EngineConfig(update="gibbs", randomness="fused", execution="scan",
                                       chunk_steps=1000))
    before = jexchange._scan_segment._cache_size()
    want = jt.ReplicaExchange(jt.Ladder.geometric(2, beta_min=0.3), jeng,
                              swap_every=swap).run(jax.random.PRNGKey(KEY), jtarget, n, inits)
    jax_programs = jexchange._scan_segment._cache_size() - before
    assert jax_programs == 4
    ladder = tempering.Ladder.geometric(2, beta_min=0.3)
    eng = ts.MHEngine(ts.EngineConfig(update="gibbs", randomness="fused", execution="scan",
                                      chunk_steps=4), device="cpu")
    rex = tempering.ReplicaExchange(ladder, eng, swap_every=swap)
    assert rex.tie_events(prng.PRNGKey(KEY), target, n, inits) == {"moves": 0, "swaps": 0}
    for _ in range(2):
        got = rex.run(prng.PRNGKey(KEY), target, n, inits)
        assert len(rex._programs) == jax_programs
        for f in ("samples", "accept_count", "final_words", "final_logp"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
        for f in SWAP_FIELDS:
            np.testing.assert_array_equal(getattr(got.swap, f), getattr(want.swap, f), f)
    assert {(sig[1], sig[2]) for sig in rex._programs} == {(6, 0), (6, 1), (4, 0), (4, 1)}
    for cfg in (dict(execution="pallas"), dict(execution="scan", collect="thin:2")):
        other = ts.MHEngine(ts.EngineConfig(update="gibbs", randomness="fused", **cfg),
                            device="cpu")
        other_rex = tempering.ReplicaExchange(ladder, other, swap_every=swap)
        other_rex.run(prng.PRNGKey(KEY), target, n, inits)
        assert other_rex._programs == {}


@pytest.mark.parametrize("kind", ["table", "spin_glass"])
def test_one_replica_ladder_is_a_plain_run(kind):
    _, target, init = _targets(kind)
    eng = ts.MHEngine(ts.EngineConfig(update=_update(kind), chunk_steps=8), device="cpu")
    rex = tempering.ReplicaExchange(tempering.Ladder((1.0,)), eng, swap_every=7)
    tempered = rex.run(prng.PRNGKey(3), target, 25, init[None])
    plain = eng.run(prng.PRNGKey(3), target, 25, init)
    for f in ("samples", "accept_count", "final_words"):
        assert torch.equal(getattr(tempered, f)[0], getattr(plain, f)), f
    assert tempered.swap.events == 0


def test_replica_streams_are_chain_slots():
    _, target, init = _targets("table")
    ladder = tempering.Ladder.geometric(3, beta_min=0.5)
    eng = ts.MHEngine(ts.EngineConfig(chunk_steps=8), device="cpu")
    tempered = tempering.ReplicaExchange(ladder, eng, swap_every=1000).run(
        prng.PRNGKey(11), target, 12, np.broadcast_to(init, (3, *init.shape)))
    for r, beta in enumerate(ladder.betas):
        solo = eng.run(prng.PRNGKey(11), tempering.scaled_target(target, beta), 12, init,
                       chain_id=r)
        assert torch.equal(tempered.samples[r], solo.samples)


def test_collect_thin_and_last():
    """The collection axis rides the absolute steps: ``thin:k`` keeps the
    strided "all" stream, ``last`` keeps none and the same finals."""
    _, target, init = _targets("spin_glass")
    inits = np.broadcast_to(init, (R, *init.shape))
    runs = {}
    for collect in ("all", "thin:4", "last"):
        eng = ts.MHEngine(ts.EngineConfig(update="gibbs", chunk_steps=5, collect=collect),
                          device="cpu")
        runs[collect] = tempering.ReplicaExchange(
            tempering.Ladder.geometric(R), eng, swap_every=SWAP).run(
            prng.PRNGKey(2), target, N, inits)
    assert torch.equal(runs["thin:4"].samples, runs["all"].samples[:, ::4])
    assert runs["last"].samples.shape[1] == 0
    assert torch.equal(runs["last"].final_words, runs["all"].final_words)


def test_equal_betas_always_swap_and_round_trips():
    _, target, init = _targets("table")
    eng = ts.MHEngine(ts.EngineConfig(chunk_steps=8), device="cpu")
    res = tempering.ReplicaExchange(tempering.Ladder((1.0, 1.0, 1.0)), eng, swap_every=4).run(
        prng.PRNGKey(0), target, 16, np.broadcast_to(init, (3, *init.shape)))
    assert res.swap.summary()["swap_events"] == 3
    assert res.swap.summary()["swap_accept_rate"] == 1.0
    res = tempering.ReplicaExchange(tempering.Ladder((1.0, 1.0)), eng, swap_every=2).run(
        prng.PRNGKey(0), target, 20, np.broadcast_to(init, (2, *init.shape)))
    assert res.swap.summary()["round_trips"] > 0


@pytest.mark.parametrize("randomness", ["host", "cim"])
def test_swap_acceptance_strictly_inside_unit_interval(randomness):
    """On a frustrated glass every pair accepts some swaps and rejects
    some, under both operand backends (tests/test_tempering.py)."""
    model = SpinGlass.bimodal(prng.PRNGKey(1), 4, 4)
    init = model.random_init(prng.PRNGKey(2), 4)
    eng = ts.MHEngine(ts.EngineConfig(update="gibbs", randomness=randomness, chunk_steps=8),
                      device="cpu")
    res = tempering.ReplicaExchange(tempering.Ladder.geometric(4, beta_min=0.2), eng,
                                    swap_every=4).run(prng.PRNGKey(2), model, 96,
                                                      init.expand(4, *init.shape))
    for rate in res.swap.summary()["pair_accept_rate"]:
        assert 0.0 < rate < 1.0


def test_swap_accept_flush_and_nan():
    """The MH accept expression: exp below 2^-126 is 0 (u = 0 never
    swaps there), a NaN delta never swaps, delta >= 0 always does."""
    delta = torch.tensor([[-88.0, -87.0, float("nan"), 0.0, 3.0]])
    u = torch.zeros_like(delta)
    active = torch.ones((1, 1), dtype=torch.bool)
    got = tempering.exchange.swap_accept(delta, u, active)
    assert got.tolist() == [[False, True, False, True, True]]
    assert not tempering.exchange.swap_accept(delta, u, ~active).any()


# --- annealing ----------------------------------------------------------------


def _recording(engine):
    """Record every plan ``engine`` submits."""
    plans, real = [], engine.submit

    def submit(plan, **kw):
        plans.append(plan)
        return real(plan, **kw)

    engine.submit = submit
    return plans


def _plan_ties(engine, plans):
    n = 0
    for plan in plans:
        key = ts.chain_key(engine._key(plan.key), plan.chain_id)
        init = engine._words(plan.init_words)
        if engine.config.update == "gibbs":
            _, u = engine.randomness.chunk(key, plan.step0, plan.n_steps, tuple(init.shape), 1,
                                           need_flips=False)
            n += gref.chain_ties(init, u, plan.target.logit_spec, plan.step0 % 2).shape[0]
        else:
            flips, u = engine.randomness.chunk(key, plan.step0, plan.n_steps,
                                               tuple(init.shape), plan.target.nbits)
            n += mref.tie_events(plan.target.table, init, flips, u, plan.target.nbits).shape[0]
    return n


@partitionable
@pytest.mark.parametrize("kind", ["ising", "spin_glass"])
def test_anneal_equals_jax(kind):
    jtarget, target, init = _targets(kind)
    cfg = dict(update=_update(kind), randomness="fused", execution="pallas", chunk_steps=4)
    jres = jt.Annealer.geometric(4, 6, 0.4, 4.0).run(
        jax.random.PRNGKey(5), jtarget, init, engine=js.MHEngine(js.EngineConfig(**cfg)))
    eng = ts.MHEngine(ts.EngineConfig(**cfg), device="cpu")
    plans = _recording(eng)
    res = tempering.Annealer.geometric(4, 6, 0.4, 4.0).run(prng.PRNGKey(5), target, init,
                                                           engine=eng)
    assert len(plans) == 4 and _plan_ties(eng, plans) == 0
    for f in ("best_words", "best_logp", "final_words", "accept_count"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f)), f)
    assert np.float32(res.acceptance_rate.item()) == np.float32(jres.acceptance_rate)
    assert res.betas == jres.betas and res.n_steps == jres.n_steps


@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
def test_anneal_reaches_exhaustive_ground_state(randomness):
    """The optimality criterion of tests/test_tempering.py on a 4 x 4 ±J
    glass: the best state ever visited hits the brute-force ground."""
    model = SpinGlass.bimodal(prng.PRNGKey(1), 4, 4)
    init = model.random_init(prng.PRNGKey(2), 2)
    ground, _ = exhaustive_ground_state(model)
    eng = ts.MHEngine(ts.EngineConfig(update="gibbs", randomness=randomness, chunk_steps=16),
                      device="cpu")
    res = tempering.Annealer.geometric(8, 32, beta_min=0.4, beta_max=4.0).run(
        prng.PRNGKey(0), model, init, engine=eng)
    assert float(res.best_energy.min()) == ground
    assert torch.equal(model.energy(res.best_words), res.best_energy)


def test_single_stage_beta_one_is_a_plain_run():
    _, model, init = _targets("spin_glass")
    eng = ts.MHEngine(ts.EngineConfig(update="gibbs", chunk_steps=8), device="cpu")
    res = tempering.Annealer((1.0,), 16).run(prng.PRNGKey(5), model, init, engine=eng)
    plain = eng.run(prng.PRNGKey(5), model, 16, init)
    assert torch.equal(res.final_words, plain.final_words)
    assert torch.equal(res.accept_count, plain.accept_count)


def test_stage_best_takes_the_first_maximum():
    f = torch.tensor([[1.0, 5.0], [3.0, 5.0], [3.0, 2.0]])
    samples = torch.arange(6).reshape(3, 2)
    words, best = tempering.anneal._stage_best(samples, f)
    assert words.tolist() == [2, 1] and best.tolist() == [3.0, 5.0]
