"""The port's Gibbs engine and lattice workloads against the JAX package.

The engine grid is {scan, pallas} x {host, cim, fused} x {chunked,
monolithic} x step0 {0, 7} x num_chains {1, 3} x collect {all, thin:3,
last} on an 8 x 8 Ising lattice, and a smaller grid on an odd 5 x 7 Ising
lattice and a 6 x 8 spin glass.  For each (lattice, backend, step0) the
JAX engine's Pallas executor (interpret mode) runs three chains once,
jitted with a traced ``step0``, collect "all"; the port's cells are held
against that run through the JAX package's own contracts (chain c of a
C-chain run equals a solo run with ``chain_id=c``; ``thin:k`` keeps the
absolute steps ``(step0 + t) % k == 0``; ``last`` keeps the final carry).
States, flip counts and rates are compared with tolerance 0 and no tie
event (asserted for every chain's draws); ``final_logp`` within 4 ULP,
the largest gap measured between XLA's and PyTorch's log-sigmoid.

The workload builders, couplings, inits, observables, diagnostics and
dispatch errors are compared with the JAX package's from the same keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro import workloads as jw
from repro.workloads import ising as jising
from repro.workloads import spin_glass as jglass
from repro_torch import convert, prng, workloads
from repro_torch import samplers as ts
from repro_torch.kernels.gibbs import gibbs as gk
from repro_torch.kernels.gibbs import ref
from repro_torch.workloads import ising, spin_glass

B, N, CHAINS, SEED = 2, 13, 3, 21
LOGP_ULPS = 4

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _models(lattice):
    """(JAX model, port model) with the same parameters."""
    if lattice == "glass":
        rs = np.random.default_rng(4)
        jr, jd = (rs.choice([-1.0, 1.0], size=(6, 8)).astype(np.float32) for _ in range(2))
        return (
            jglass.SpinGlass(jr, jd, field=0.1),
            spin_glass.SpinGlass(*convert.couplings_from_numpy(jr, jd, device="cpu"), field=0.1),
        )
    h, w = (8, 8) if lattice == "ising" else (5, 7)
    jm = jising.IsingModel(h, w, beta=0.4407, field=0.05)
    return jm, convert.ising_from_jax(jm)


def _init(lattice):
    jm, _ = _models(lattice)
    rs = np.random.default_rng([SEED, jm.height])
    return rs.integers(0, 2, size=(CHAINS, B, jm.height, jm.width)).astype(np.uint32)


def _cfg(randomness, **kw):
    return dict(update="gibbs", randomness=randomness, p_bfr=0.4, **kw)


def _assert_no_ties(lattice, randomness, step0):
    """Replay every chain of the reference run with the port's uniforms:
    no active site-step may be a tie event."""
    _, model = _models(lattice)
    init = torch.from_numpy(_init(lattice).astype(np.int64))
    backend = ts.EngineConfig(**_cfg(randomness)).backend()
    keys = ts.chain_keys(prng.PRNGKey(SEED), CHAINS)
    for c in range(CHAINS):
        _, u = backend.chunk(keys[c], step0, N, tuple(init[c].shape), 1, need_flips=False)
        ties = ref.chain_ties(init[c], u, model.logit_spec, step0 % 2)
        assert ties.shape[0] == 0, f"tie events {ties.tolist()} in chain {c}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's int64 Threefry runs many small element-wise ops; on a
    CPU shared by several test workers, torch's intra-op threads spin
    against each other, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("samples", "accept_count", "final_words", "final_logp")


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}

    def get(lattice, randomness, step0):
        if (lattice, randomness, step0) not in runs:
            jm, _ = _models(lattice)
            eng = js.MHEngine(js.EngineConfig(
                **_cfg(randomness, execution="pallas", num_chains=CHAINS, chunk_steps=1000)
            ))
            run = jax.jit(lambda w, s: eng.run(jax.random.PRNGKey(SEED), jm, N, w, step0=s))
            for s0 in (0, 7):
                _assert_no_ties(lattice, randomness, s0)
                res = run(_init(lattice), s0)
                runs[lattice, randomness, s0] = {f: np.asarray(getattr(res, f)) for f in FIELDS}
        return runs[lattice, randomness, step0]

    return get


def _kept(samples, collect, step0):
    """The JAX package's kept set, from its "all" stream (time axis 1)."""
    mode, k = js.parse_collect(collect)
    if mode == "all":
        return samples
    if mode == "thin":
        return samples[:, (-step0) % k::k]
    return samples[:, :0]


def _check_cell(jax_runs, lattice, randomness, execution, collect, num_chains, step0, chunk,
                tensor_step0=False):
    want = dict(jax_runs(lattice, randomness, step0))
    want["samples"] = _kept(want["samples"], collect, step0)
    _, model = _models(lattice)
    init = _init(lattice)
    eng = ts.MHEngine(
        ts.EngineConfig(**_cfg(
            randomness, execution=execution, num_chains=num_chains, collect=collect,
            chunk_steps=chunk,
        )),
        device="cpu",
    )
    chain = slice(None) if num_chains == CHAINS else 1
    h = eng.submit(ts.RunPlan(
        target=model, n_steps=N, init_words=init[chain], seed=SEED,
        step0=torch.tensor(step0) if tensor_step0 else step0,
        chain_id=0 if num_chains == CHAINS else 1,
    ))
    got = convert.result_to_numpy(h.result)
    for f in FIELDS[:3]:
        np.testing.assert_array_equal(got[f], want[f][chain])
    np.testing.assert_array_max_ulp(got["final_logp"], want["final_logp"][chain], LOGP_ULPS)
    acc = want["accept_count"][chain]
    assert got["acceptance_rate"] == np.float32(acc.sum()) / (
        np.float32(N) * np.float32(acc.size)
    )
    assert got["n_steps"] == N
    return h.result


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("collect", ["all", "thin:3", "last"])
@pytest.mark.parametrize("num_chains", [1, 3])
@pytest.mark.parametrize("step0", [0, 7])
@pytest.mark.parametrize("chunk", [5, 1000])
def test_gibbs_engine_grid(jax_runs, randomness, execution, collect, num_chains, step0, chunk):
    _check_cell(jax_runs, "ising", randomness, execution, collect, num_chains, step0, chunk)


@partitionable
@pytest.mark.parametrize("lattice", ["odd", "glass"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("num_chains", [1, 3])
@pytest.mark.parametrize("step0", [0, 7])
def test_gibbs_engine_lattices(jax_runs, lattice, randomness, execution, num_chains, step0):
    _check_cell(jax_runs, lattice, randomness, execution, "all", num_chains, step0, 4)


@partitionable
@pytest.mark.parametrize("lattice", ["ising", "glass"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("collect", ["all", "last"])
def test_gibbs_tensor_step0_equals_jax(jax_runs, lattice, randomness, execution, collect):
    """A 0-d int64 tensor ``step0`` at an odd offset: the scan half-sweep
    parity is the tensor ``(start + t) % 2`` and the kernels take it as an
    operand; three chains, chunks of 5."""
    _check_cell(jax_runs, lattice, randomness, execution, collect, CHAINS, 7, 5,
                tensor_step0=True)


@partitionable
@pytest.mark.parametrize("lattice", ["ising", "odd"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("collect", ["thin:3", "last"])
def test_gibbs_results_keep_their_dtypes(jax_runs, lattice, randomness, execution, collect):
    """The kernels write int32 spins; the engine's results stay int64 words
    and int32 counts (the kept rows and the final words widened), equal to
    JAX's Pallas-interpret run, and to the port's scan run."""
    got = _check_cell(jax_runs, lattice, randomness, execution, collect, CHAINS, 7, 5)
    assert got.samples.dtype == torch.int64 and got.final_words.dtype == torch.int64
    assert got.accept_count.dtype == torch.int32 and got.final_logp.dtype == torch.float32
    _, model = _models(lattice)
    scan = ts.MHEngine(
        ts.EngineConfig(**_cfg(randomness, execution="scan", num_chains=CHAINS, collect=collect)),
        device="cpu",
    ).submit(ts.RunPlan(target=model, n_steps=N, init_words=_init(lattice), seed=SEED, step0=7))
    for f in FIELDS:
        a, b = getattr(got, f), getattr(scan.result, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_resume_across_odd_step0(randomness, execution):
    """submit(13) + resume(11) == submit(24): the second segment starts at
    an odd absolute step, so it must start on the other colour."""
    wl = workloads.build(
        "ising", np.array([0, 3], np.uint32), randomness=randomness, backend=execution,
        smoke=True, n_steps=24, chunk_steps=5, device="cpu",
    )
    plan = wl.plan(prng.PRNGKey(8))
    full = wl.engine.submit(plan)
    first = wl.engine.submit(plan.replace(n_steps=13))
    assert first.resume_plan(11).init_logp is None
    second = first.resume(11)
    assert second.progress == 24
    assert torch.equal(torch.cat([first.samples, second.samples]), full.samples)
    for f in ("final_words", "final_logp"):
        assert torch.equal(getattr(second, f), getattr(full, f))
    assert torch.equal(first.accept_count + second.accept_count, full.accept_count)


# --- workloads ---------------------------------------------------------------

KEY = np.asarray(jax.random.PRNGKey(42))


@partitionable
@pytest.mark.parametrize("batch", [1, 3])
def test_random_init_matches_jax(batch):
    jm = jising.IsingModel(5, 6)
    got = ising.IsingModel(5, 6).random_init(prng.PRNGKey(9), batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.random_init(jax.random.PRNGKey(9), batch)))


@partitionable
@pytest.mark.parametrize("p_ferro,j", [(0.5, 1.0), (0.8, 1.5)])
def test_bimodal_couplings_match_jax(p_ferro, j):
    jm = jglass.SpinGlass.bimodal(jnp.asarray(KEY), 6, 4, j=j, p_ferro=p_ferro, field=0.3)
    tm = spin_glass.SpinGlass.bimodal(convert.key_from_numpy(KEY, "cpu"), 6, 4, j=j,
                                      p_ferro=p_ferro, field=0.3)
    np.testing.assert_array_equal(tm.j_right.numpy(), np.asarray(jm.j_right))
    np.testing.assert_array_equal(tm.j_down.numpy(), np.asarray(jm.j_down))
    assert tm.field == jm.field


@partitionable
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("max_weight", [1, 3, 200])
def test_maxcut_matches_jax(signed, max_weight):
    jm = jglass.SpinGlass.maxcut(jnp.asarray(KEY), 4, 6, max_weight=max_weight, signed=signed)
    tm = spin_glass.SpinGlass.maxcut(convert.key_from_numpy(KEY, "cpu"), 4, 6,
                                     max_weight=max_weight, signed=signed)
    np.testing.assert_array_equal(tm.j_right.numpy(), np.asarray(jm.j_right))
    np.testing.assert_array_equal(tm.j_down.numpy(), np.asarray(jm.j_down))
    states = np.random.default_rng(0).integers(0, 2, size=(5, 4, 6)).astype(np.uint32)
    np.testing.assert_array_equal(
        tm.cut_value(torch.from_numpy(states.astype(np.int64))).numpy(),
        np.asarray(jm.cut_value(jnp.asarray(states))),
    )


@partitionable
@pytest.mark.parametrize("lo,hi", [(1, 4), (0, 2), (-7, 300), (5, 5), (-(2**31), 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    got = prng.randint(prng.PRNGKey(11), (7, 9), lo, hi)
    want = jax.random.randint(jax.random.PRNGKey(11), (7, 9), lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@partitionable
@pytest.mark.parametrize("name,kw", [
    ("ising", dict(height=5, width=7, batch=3, beta=0.44)),
    ("spin_glass", dict(height=6, width=4, batch=2)),
    ("spin_glass", dict(height=4, width=4, batch=2, maxcut=True)),
])
@pytest.mark.parametrize("num_chains", [1, 2])
def test_build_matches_jax(name, kw, num_chains):
    """Each builder's model, inits, run length and meta equal JAX's."""
    jwl = jw.build(name, jnp.asarray(KEY), num_chains=num_chains, **kw)
    twl = workloads.build(name, KEY, num_chains=num_chains, device="cpu", **kw)
    np.testing.assert_array_equal(twl.init_words.numpy(), np.asarray(jwl.init_words))
    assert (twl.n_steps, twl.burn_in, twl.meta) == (jwl.n_steps, jwl.burn_in, jwl.meta)
    if name == "spin_glass":
        np.testing.assert_array_equal(twl.target.j_right.numpy(), np.asarray(jwl.target.j_right))
        np.testing.assert_array_equal(twl.target.j_down.numpy(), np.asarray(jwl.target.j_down))
        assert twl.target.maxcut_reduction == jwl.target.maxcut_reduction
    states = twl.init_words
    np.testing.assert_array_equal(
        twl.series_fn(states).numpy(), np.asarray(jwl.series_fn(jnp.asarray(states.numpy())))
    )
    assert twl.engine.config == ts.EngineConfig(**{
        f: getattr(jwl.engine.config, f) for f in ts.EngineConfig.__dataclass_fields__
    })


@partitionable
@pytest.mark.parametrize("name", ["ising", "spin_glass"])
@pytest.mark.parametrize("num_chains,collect", [(1, "all"), (1, "thin:3"), (2, "all"), (2, "last")])
def test_diagnostics_match_jax(name, num_chains, collect):
    """``WorkloadRun.diagnostics`` equals the JAX dict from the same keys
    (Pallas executor, ``fused`` randomness, smoke size)."""
    kw = dict(randomness="fused", backend="pallas", smoke=True, num_chains=num_chains,
              collect=collect, n_steps=40, chunk_steps=8)
    jwl = jw.build(name, jnp.asarray(KEY), **kw)
    twl = workloads.build(name, KEY, device="cpu", **kw)
    run_key = np.asarray(jax.random.PRNGKey(2))
    jres = jwl.run(jnp.asarray(run_key))
    tres = twl.run(convert.key_from_numpy(run_key, "cpu"))
    np.testing.assert_array_equal(tres.samples.numpy(), np.asarray(jres.samples))
    assert twl.rate_entry(tres) == jwl.rate_entry(jres)
    assert twl.rate_key == jwl.rate_key == "flip_rate"
    assert twl.kept_burn_in() == jwl.kept_burn_in()
    if collect != "last":  # no series under last, on either side
        np.testing.assert_array_equal(twl.series(tres), jwl.series(jres))
    assert twl.diagnostics(tres) == jwl.diagnostics(jres)


def test_observables_match_jax():
    jm, tm = _models("odd")
    gm, gt = _models("glass")
    for j, t in ((jm, tm), (gm, gt)):
        states = np.random.default_rng(3).integers(0, 2, size=(4, 2, j.height, j.width))
        tstates = torch.from_numpy(states)
        np.testing.assert_array_equal(t.energy(tstates).numpy(), np.asarray(j.energy(states)))
        np.testing.assert_array_equal(
            t.conditional_logit(tstates).numpy(), np.asarray(j.conditional_logit(states))
        )
        mask = t.update_mask(tstates.shape, 1)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j.update_mask(states.shape, 1)))
    np.testing.assert_array_equal(
        tm.magnetization(tstates[..., :5, :7]).numpy(),
        np.asarray(jm.magnetization(states[..., :5, :7])),
    )


def test_exhaustive_ground_state_matches_jax():
    jm = jglass.SpinGlass.bimodal(jax.random.PRNGKey(5), 4, 4)
    tm = spin_glass.SpinGlass(*convert.couplings_from_numpy(jm.j_right, jm.j_down, "cpu"))
    je, jstate = jglass.exhaustive_ground_state(jm)
    te, tstate = spin_glass.exhaustive_ground_state(tm)
    assert te == je
    np.testing.assert_array_equal(tstate, jstate)
    with pytest.raises(ValueError, match="20 sites"):
        spin_glass.exhaustive_ground_state(spin_glass.SpinGlass(torch.ones(6, 4), torch.ones(6, 4)))


# --- dispatch errors (the counterparts of tests/test_workloads.py) -------------


def _gibbs_engine(**kw):
    kw.setdefault("update", "gibbs")
    return ts.MHEngine(ts.EngineConfig(**kw), device="cpu")


def test_update_rule_validation():
    with pytest.raises(ValueError):
        ts.EngineConfig(update="metropolis-within-gibbs")


def test_gibbs_needs_conditional_target():
    table = ts.TableTarget(torch.zeros(1, 16))
    with pytest.raises(ValueError, match="conditional"):
        _gibbs_engine(execution="scan").run(
            prng.PRNGKey(0), table, 4, torch.zeros(1, 4, dtype=torch.int64)
        )


def test_pallas_gibbs_needs_fused_lattice_model():
    table = ts.TableTarget(torch.zeros(1, 16))
    with pytest.raises(ValueError, match="checkerboard"):
        ts.resolve_execution("pallas", table, "cpu", "gibbs")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_gibbs_is_always_scan(device):
    """JAX's rule: auto never picks the Gibbs kernel, on any device."""
    model = ising.IsingModel(height=4, width=4)
    assert ts.resolve_execution("auto", model, device, "gibbs") == "scan"
    assert ts.resolve_execution("pallas", model, device, "gibbs") == "pallas"


def test_pallas_gibbs_rejects_flat_state():
    model = ising.IsingModel(8, 8)
    with pytest.raises(ValueError, match="lattice state"):
        _gibbs_engine(execution="pallas").run(
            prng.PRNGKey(0), model, 4, torch.zeros(16, dtype=torch.int64)
        )


def test_gibbs_refuses_init_logp_and_foreign_couplings():
    model = ising.IsingModel(4, 4)
    init = torch.zeros(1, 4, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="init_logp"):
        _gibbs_engine().run(prng.PRNGKey(0), model, 2, init, init_logp=torch.zeros(1, 4, 4))
    glass = spin_glass.SpinGlass(torch.ones(4, 4), torch.ones(4, 4))
    eng = _gibbs_engine()
    eng.device = torch.device("meta")  # any device other than the couplings'
    with pytest.raises(ValueError, match="j_right"):
        eng.run(prng.PRNGKey(0), glass, 2, init)


def test_workload_registry():
    assert sorted(workloads.WORKLOADS) == ["gmm", "ising", "spin_glass"]
    assert workloads.build("gmm", KEY, smoke=True, device="cpu").name == "gmm"
    with pytest.raises(ValueError, match="unknown workload"):
        workloads.build("potts", KEY, device="cpu")
    with pytest.raises(ValueError, match="even"):
        spin_glass.SpinGlass(torch.ones(5, 4), torch.ones(5, 4))
    with pytest.raises(ValueError, match="2x2"):
        ising.IsingModel(1, 4)


def test_main_path_launch_counts_stay_zero_on_cpu():
    gk.reset_launches()
    wl = workloads.build("ising", KEY, randomness="fused", backend="pallas", smoke=True,
                         device="cpu")
    wl.run(prng.PRNGKey(1))
    assert gk.LAUNCHES == {"gibbs_chain": 0, "gibbs_chain_fused": 0}


def test_convert_lattice_helpers():
    words = np.random.default_rng(0).integers(0, 2, size=(2, 3, 4, 4)).astype(np.uint32)
    got = convert.words_from_numpy(words, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (2, 3, 4, 4)
    assert convert.words_from_numpy(words[0], device="cpu").shape == (3, 4, 4)
    with pytest.raises(ValueError):
        convert.words_from_numpy(words[None], device="cpu")
    jr, jd = convert.couplings_from_numpy(np.ones((4, 6)), -np.ones((4, 6)), device="cpu")
    assert jr.dtype == torch.float32 and float(jd.sum()) == -24.0
    model = convert.ising_from_jax(jising.IsingModel(6, 5, beta=0.3, field=-0.1))
    assert (model.height, model.width, model.beta, model.field) == (6, 5, 0.3, -0.1)
