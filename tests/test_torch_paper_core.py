"""The port's paper core — targets, proposal, energy model, the
``metropolis`` shim and the CIM macro — against the JAX package, at the
sizes of ``tests/test_core_sampling.py`` and
``tests/test_core_paper_claims.py``.

Tolerances:

  * integer words (Gray codes, encodes, proposals, inits, chain states,
    accept counts), grid coordinates and the energy model: 0;
  * the bivariate Gaussian's log density: 0 (its quadratic form keeps
    XLA's fused multiply-add order, ``core/targets.py:_dot``);
  * the Gaussian mixture's log density: ``GMM_ULPS`` = 1 ULP against the
    eager and the jitted JAX tables — the gap is ``log`` (XLA's and
    PyTorch's differ by an ULP); measured: 1 cell of 256 eager, 3 under
    ``jit``;
  * ``acceptance_rate`` of the jitted JAX shim: 1 ULP (XLA turns the
    division into a reciprocal multiply under ``jit``).

Chains whose target is a density are equal except at tie events; every
seed here is replayed with the port's table and asserted to have none
within ``TIE_ULPS`` = 4 ULP of each log-prob (``kernels/mh/ref.py:
tie_events``), a margin that covers the card's ``exp``/``log`` too.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import metropolis as jmetropolis
from repro.core import proposal as jproposal
from repro.core import targets as jtargets
from repro.core.macro import CIMMacro as JMacro
from repro.core.macro import MacroConfig as JMacroConfig
from repro_torch import convert, prng, samplers
from repro_torch.core import energy, metropolis, proposal, targets
from repro_torch.core.macro import CIMMacro, MacroConfig, MacroMode
from repro_torch.kernels.mh import ref

GMM_ULPS = 1
TIE_ULPS = 4

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small element-wise ops: one intra-op thread per test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps(a, b) -> int:
    """Largest distance in float32 ULP between two arrays of one sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _key(jkey) -> torch.Tensor:
    return convert.key_from_numpy(np.asarray(jkey), device="cpu")


def _words(n, seed=0) -> tuple:
    rs = np.random.default_rng([n, seed])
    w = rs.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return w, torch.from_numpy(w.astype(np.int64))


CODECS = {
    "gmm8": dict(nbits=8, dim=1, lo=(-10.0,), hi=(10.0,)),
    "mgd12": dict(nbits=12, dim=2, lo=(-4.0, -4.0), hi=(4.0, 4.0)),
    "gray10": dict(nbits=10, dim=2, lo=(-3.0, 0.5), hi=(2.5, 7.25), gray=True),
    "default6": dict(nbits=6),
}


def _codecs(name):
    return jtargets.GridCodec(**CODECS[name]), targets.GridCodec(**CODECS[name])


def _densities(name):
    if name == "gmm":
        return jtargets.GaussianMixture.paper_gmm(), targets.GaussianMixture.paper_gmm()
    return jtargets.MultivariateGaussian.paper_mgd(), targets.MultivariateGaussian.paper_mgd()


# --- targets --------------------------------------------------------------


def test_gray_codes_match_jax():
    jw, tw = _words(5000)
    np.testing.assert_array_equal(
        np.asarray(jtargets.binary_to_gray(jw)).astype(np.int64),
        targets.binary_to_gray(tw).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jtargets.gray_to_binary(jw)).astype(np.int64),
        targets.gray_to_binary(tw).numpy(),
    )
    assert torch.equal(targets.gray_to_binary(targets.binary_to_gray(tw)), tw)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_decode_encode_match_jax(name):
    jc, tc = _codecs(name)
    words = np.arange(1 << jc.nbits, dtype=np.uint32)
    jx = np.asarray(jc.decode(jnp.asarray(words)))
    tx = tc.decode(torch.from_numpy(words.astype(np.int64)))
    assert tx.dtype == torch.float32
    np.testing.assert_array_equal(jx, tx.numpy())
    np.testing.assert_array_equal(jx, np.asarray(jax.jit(jc.decode)(jnp.asarray(words))))
    # encode: the cell centres round-trip, and points in and outside the box
    assert torch.equal(tc.encode(tx), torch.from_numpy(words.astype(np.int64)))
    rs = np.random.default_rng(jc.nbits)
    pts = rs.uniform(-12, 12, size=(3000, jc.dim)).astype(np.float32)
    pts[:5] = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)[:, None]
    np.testing.assert_array_equal(
        np.asarray(jc.encode(jnp.asarray(pts))).astype(np.int64),
        tc.encode(torch.from_numpy(pts)).numpy(),
    )


def test_codec_validation():
    with pytest.raises(ValueError, match="divide"):
        targets.GridCodec(nbits=7, dim=2, lo=(0.0, 0.0), hi=(1.0, 1.0))
    with pytest.raises(ValueError, match="lo/hi"):
        targets.GridCodec(nbits=8, dim=2)


@pytest.mark.parametrize("density,codec,ulps", [("gmm", "gmm8", GMM_ULPS), ("mgd", "mgd12", 0)])
def test_density_tables_match_jax(density, codec, ulps):
    """The log density at every cell of the paper's Fig. 17 grids, against
    JAX eager (the gmm workload's table) and jit (the macro's chains)."""
    (jd, td), (jc, tc) = _densities(density), _codecs(codec)
    words = np.arange(1 << jc.nbits, dtype=np.uint32)
    jfn = jtargets.discretized_target(jd, jc)
    got = targets.discretized_target(td, tc)(torch.from_numpy(words.astype(np.int64)))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    for want in (jfn(jnp.asarray(words)), jax.jit(jfn)(jnp.asarray(words))):
        assert _ulps(want, got.numpy()) <= ulps
    jp, tp = jtargets.reference_grid_probs(jd, jc), targets.reference_grid_probs(td, tc)
    np.testing.assert_allclose(tp, jp, rtol=4 * ulps * 2.0**-23, atol=0)
    assert tp.sum() == pytest.approx(1.0, abs=1e-12)


def test_densities_at_random_points():
    rs = np.random.default_rng(0)
    x1 = rs.normal(scale=5.0, size=(4000, 1)).astype(np.float32)
    x2 = rs.normal(scale=2.0, size=(4000, 2)).astype(np.float32)
    (jg, tg), (jm, tm) = _densities("gmm"), _densities("mgd")
    assert _ulps(jg.log_prob(jnp.asarray(x1)), tg.log_prob(torch.from_numpy(x1))) <= GMM_ULPS
    np.testing.assert_array_equal(
        np.asarray(jm.log_prob(jnp.asarray(x2))), tm.log_prob(torch.from_numpy(x2)).numpy()
    )


def test_logsumexp_matches_jax():
    rs = np.random.default_rng(1)
    x = (rs.normal(size=(500, 4)) * 30).astype(np.float32)
    x[:5] = -np.inf  # all components impossible: JAX gives -inf
    want = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(x), axis=-1))
    got = targets.logsumexp(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    assert _ulps(want[5:], got[5:]) <= 1


def test_table_and_categorical_targets_match_jax():
    rs = np.random.default_rng(2)
    table = rs.normal(size=100).astype(np.float32)
    words = np.concatenate([
        np.arange(120, dtype=np.uint32), np.array([2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    ])
    tw = torch.from_numpy(words.astype(np.int64))
    for jfn, tfn in (
        (jtargets.table_target(table), targets.table_target(torch.from_numpy(table))),
        (jtargets.categorical_from_logits(table, 0.7),
         targets.categorical_from_logits(torch.from_numpy(table), 0.7)),
    ):
        np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(words))), tfn(tw).numpy())


# --- proposal -------------------------------------------------------------


@partitionable
@pytest.mark.parametrize("nbits,p", [(8, 0.45), (5, 0.3), (32, 0.4)])
def test_propose_bitflip_matches_jax(nbits, p):
    jw, tw = _words(777)
    jkey = jax.random.PRNGKey(nbits)
    want = jproposal.propose_bitflip(jkey, jnp.asarray(jw).reshape(7, 111), p, nbits=nbits)
    got = proposal.propose_bitflip(_key(jkey), tw.reshape(7, 111), p, nbits)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    flips, _ = _words(777, seed=1)
    np.testing.assert_array_equal(
        np.asarray(jproposal.propose_bitflip_from_words(jw, flips, nbits)).astype(np.int64),
        proposal.propose_bitflip_from_words(tw, torch.from_numpy(flips.astype(np.int64)),
                                            nbits).numpy(),
    )


def test_bitflip_rate():
    """tests/test_core_sampling.py's rate check, on the port's stream."""
    cand = proposal.propose_bitflip(prng.PRNGKey(0), torch.zeros(50_000, dtype=torch.int64),
                                    0.45, nbits=8)
    frac = float(((cand[:, None] >> torch.arange(8)) & 1).float().mean())
    assert frac == pytest.approx(0.45, abs=0.01)


def test_transfer_and_transition_matrices_match_jax():
    x, y = np.array([0b1010, 0b1111, 7]), np.array([0b0000, 0b1110, 0])
    np.testing.assert_array_equal(jproposal.hamming_distance(x, y), proposal.hamming_distance(x, y))
    rs = np.random.default_rng(3)
    for nbits, p in ((3, 0.4), (4, 0.45), (5, 0.1)):
        np.testing.assert_array_equal(
            jproposal.transfer_matrix(nbits, p), proposal.transfer_matrix(nbits, p)
        )
        logp = rs.normal(size=1 << nbits)
        pm = proposal.mh_transition_matrix(nbits, p, logp)
        np.testing.assert_array_equal(jproposal.mh_transition_matrix(nbits, p, logp), pm)
        pi = np.exp(logp) / np.exp(logp).sum()
        assert np.allclose(pi @ proposal.mh_transition_matrix(nbits, p, np.log(pi)), pi,
                           atol=1e-12)
    with pytest.raises(ValueError):
        proposal.mh_transition_matrix(3, 0.4, np.zeros(7))


# --- energy ---------------------------------------------------------------


def test_energy_model_matches_jax():
    for nbits in (1, 4, 8, 12, 16, 32, 64):
        for fn in ("energy_accepted_fj", "energy_rejected_fj", "iteration_time_ns",
                   "throughput_per_chain", "throughput_aggregate"):
            assert getattr(energy, fn)(nbits) == getattr(jenergy, fn)(nbits)
        for ar in (0.0, 0.3, 0.35, 0.4, 1.0):
            assert energy.energy_per_sample_fj(ar, nbits) == jenergy.energy_per_sample_fj(ar, nbits)
            assert energy.power_w(nbits, ar) == jenergy.power_w(nbits, ar)
        assert energy.time_for_samples_s(10**6, nbits) == jenergy.time_for_samples_s(10**6, nbits)
    led, jled = energy.EnergyLedger(nbits=8, n_chains=64), jenergy.EnergyLedger(nbits=8, n_chains=64)
    led, jled = led.add(14848, 7575).add(64, 1), jled.add(14848, 7575).add(64, 1)
    for f in ("n_rejected", "energy_pj", "time_s", "energy_per_sample_pj"):
        assert getattr(led, f) == getattr(jled, f)
    # the paper's anchors (§6.4, §6.5) hold in the copy
    assert energy.energy_accepted_fj(4) == pytest.approx(506.5, abs=0.1)
    assert energy.energy_rejected_fj(4) == pytest.approx(554.7, abs=0.1)
    assert energy.throughput_per_chain(4) == pytest.approx(166.7e6, rel=1e-3)
    with pytest.raises(ValueError):
        energy.energy_per_sample_fj(1.5)
    with pytest.raises(ValueError):
        energy.iteration_time_ns(65)


# --- metropolis and the macro ---------------------------------------------


def _assert_no_ties(key, log_prob_fn, cfg, chain_shape, n_steps):
    """Replay the shim's chain with the port's operands and its table of
    ``log_prob_fn`` over every word: no step may be a tie event within
    ``TIE_ULPS`` of each log-prob."""
    k_init, k = prng.split(key)
    init = prng.randint(k_init, chain_shape, 0, 1 << cfg.nbits, dtype="uint32")
    backend = cfg.engine_config().backend()
    k = samplers.chain_key(k, 0)
    ops = [backend.chunk(k, s, min(256, n_steps - s), chain_shape, cfg.nbits)
           for s in range(0, n_steps, 256)]
    flips = torch.cat([f for f, _ in ops])[:, None]
    u = torch.cat([u for _, u in ops])[:, None]
    table = log_prob_fn(torch.arange(1 << cfg.nbits))[None]
    ties = ref.tie_events(table, init[None], flips, u, cfg.nbits, logp_ulps=TIE_ULPS)
    assert ties.shape[0] == 0, f"tie events at {ties[:5].tolist()}"


def _check_chain(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.samples).astype(np.int64), tres.samples.numpy())
    np.testing.assert_array_equal(
        np.asarray(jres.final.words).astype(np.int64), tres.final.words.numpy()
    )
    np.testing.assert_array_equal(np.asarray(jres.final.accept_count), tres.final.accept_count.numpy())
    assert int(jres.n_steps) == tres.n_steps
    assert _ulps(jres.acceptance_rate, tres.acceptance_rate.numpy()) <= 1


@partitionable
def test_run_chain_table_target_matches_jax():
    """tests/test_core_sampling.py::test_discrete_target_tv_distance's run."""
    rs = np.random.default_rng(2)
    table = rs.normal(size=32).astype(np.float32)
    jcfg = jmetropolis.MHConfig(nbits=5, burn_in=500, rng_bit_width=16)
    cfg = metropolis.MHConfig(nbits=5, burn_in=500, rng_bit_width=16)
    jfn, tfn = jtargets.table_target(jnp.asarray(table)), targets.table_target(torch.from_numpy(table))
    jkey = jax.random.PRNGKey(3)
    _assert_no_ties(_key(jkey), tfn, cfg, (64,), 2500)
    jres = jmetropolis._run_chain_impl(jkey, jfn, jcfg, 2000, (64,))
    with pytest.warns(DeprecationWarning, match="RunPlan"):
        tres = metropolis.run_chain(_key(jkey), tfn, cfg, 2000, (64,), device="cpu")
    _check_chain(jres, tres)
    np.testing.assert_array_equal(np.asarray(jres.final.log_prob), tres.final.log_prob.numpy())
    assert metropolis.effective_sample_count(tres) == 2000 * 64
    counts = np.bincount(tres.samples.numpy().reshape(-1), minlength=32)
    p = np.exp(table.astype(np.float64)) / np.exp(table.astype(np.float64)).sum()
    assert 0.5 * np.abs(counts / counts.sum() - p).sum() < 0.02


@partitionable
def test_run_chain_gmm_grid_matches_jax():
    """tests/test_core_sampling.py::test_gmm_grid_sampling's run: a
    callable density target, evaluated per step on both sides."""
    (jd, td), (jc, tc) = _densities("gmm"), (
        jtargets.GridCodec(7, 1, (-10.0,), (10.0,)), targets.GridCodec(7, 1, (-10.0,), (10.0,))
    )
    jcfg = jmetropolis.MHConfig(nbits=7, burn_in=500, rng_bit_width=16)
    cfg = metropolis.MHConfig(nbits=7, burn_in=500, rng_bit_width=16)
    tfn = targets.discretized_target(td, tc)
    jkey = jax.random.PRNGKey(4)
    _assert_no_ties(_key(jkey), tfn, cfg, (64,), 2000)
    jres = jmetropolis._run_chain_impl(jkey, jtargets.discretized_target(jd, jc), jcfg, 1500, (64,))
    tres = metropolis._run_chain_impl(_key(jkey), tfn, cfg, 1500, (64,), device="cpu")
    _check_chain(jres, tres)
    assert _ulps(jres.final.log_prob, tres.final.log_prob.numpy()) <= GMM_ULPS


@partitionable
def test_run_chain_thin_and_init_match_jax():
    jd, td = _densities("mgd")
    jc, tc = _codecs("mgd12")
    kw = dict(nbits=12, burn_in=30, thin=3, randomness="host", rng_bit_width=8)
    jcfg, cfg = jmetropolis.MHConfig(**kw), metropolis.MHConfig(**kw)
    jkey = jax.random.PRNGKey(6)
    init = np.arange(8, dtype=np.uint32) * 501
    jres = jmetropolis._run_chain_impl(
        jkey, jtargets.discretized_target(jd, jc), jcfg, 40, (8,), jnp.asarray(init)
    )
    tres = metropolis._run_chain_impl(
        _key(jkey), targets.discretized_target(td, tc), cfg, 40, (8,), init, device="cpu"
    )
    _check_chain(jres, tres)
    np.testing.assert_array_equal(np.asarray(jres.final.log_prob), tres.final.log_prob.numpy())


def _check_stats(jstats, stats):
    for f in ("n_samples", "n_steps", "energy_pj", "modeled_time_s", "energy_per_sample_pj",
              "throughput_samples_per_s"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert _ulps(np.float32(jstats.acceptance_rate), np.float32(stats.acceptance_rate)) <= 1


@partitionable
def test_macro_sample_points_matches_jax():
    """tests/test_core_sampling.py::test_macro_sampling_with_stats's run:
    the paper GMM through the 64-compartment macro, nbits 8, burn-in 200,
    2,000 samples."""
    (jd, td), (jc, tc) = _densities("gmm"), _codecs("gmm8")
    jkey = jax.random.PRNGKey(9)
    macro = CIMMacro(MacroConfig(nbits=8, burn_in=200), device="cpu")
    _assert_no_ties(_key(jkey), targets.discretized_target(td, tc), macro.mh_config(), (64,),
                    200 + 32)
    jpts, jstats = JMacro(JMacroConfig(nbits=8, burn_in=200)).sample_points(jkey, jd, jc, 2000)
    pts, stats = macro.sample_points(_key(jkey), td, tc, n_samples=2000)
    assert pts.shape == (2000, 1) and pts.dtype == np.float32
    np.testing.assert_array_equal(jpts, pts)
    _check_stats(jstats, stats)
    per_step_pj = energy.energy_per_sample_fj(stats.acceptance_rate, 8) / 1e3
    assert stats.energy_pj == pytest.approx(per_step_pj * stats.n_steps, rel=1e-3)
    assert stats.throughput_samples_per_s > 1e8


@partitionable
def test_macro_mgd_matches_jax():
    """Fig. 17(b)'s bivariate Gaussian on the 12-bit grid, cut to 640
    samples and a burn-in of 100."""
    (jd, td), (jc, tc) = _densities("mgd"), _codecs("mgd12")
    jkey = jax.random.PRNGKey(11)
    macro = CIMMacro(MacroConfig(nbits=12, burn_in=100), device="cpu")
    _assert_no_ties(_key(jkey), targets.discretized_target(td, tc), macro.mh_config(), (64,), 110)
    jpts, jstats = JMacro(JMacroConfig(nbits=12, burn_in=100)).sample_points(jkey, jd, jc, 640)
    pts, stats = macro.sample_points(_key(jkey), td, tc, n_samples=640)
    np.testing.assert_array_equal(jpts, pts)
    _check_stats(jstats, stats)


def test_macro_config_matches_jax():
    for kw in (dict(), dict(nbits=8, cvdd_pseudo_read=0.6), dict(nbits=40, temp_c=-20.0)):
        jcfg, cfg = JMacroConfig(**kw), MacroConfig(**kw)
        assert cfg.p_bfr == jcfg.p_bfr and cfg.sample_nbits == jcfg.sample_nbits
        assert dataclass_fields(cfg.mh_config()) == dataclass_fields(jcfg.mh_config())
    jrng = JMacro(JMacroConfig(nbits=8)).uniform_rng_config()
    rng = CIMMacro(MacroConfig(nbits=8), device="cpu").uniform_rng_config()
    assert (rng.p_bfr, rng.n_stages, rng.bit_width, rng.debias_error) == (
        jrng.p_bfr, jrng.n_stages, jrng.bit_width, jrng.debias_error
    )
    assert {m.value for m in MacroMode} == {"memory", "block_rng", "cim_copy"}
    with pytest.raises(ValueError):
        MacroConfig(nbits=128)
    with pytest.raises(ValueError):
        metropolis.MHConfig(nbits=33)


def dataclass_fields(x) -> dict:
    return {f: getattr(x, f) for f in x.__dataclass_fields__}


def test_entry_points_default_to_the_card():
    """The shim and the macro run on the card unless asked for the CPU."""
    fn = targets.table_target(torch.zeros(4))
    cfg = metropolis.MHConfig(nbits=2, burn_in=1)
    if torch.cuda.is_available():
        assert metropolis._run_chain_impl(prng.PRNGKey(0), fn, cfg, 2, (3,)).samples.is_cuda
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            metropolis.run_chain(prng.PRNGKey(0), fn, cfg, 2, (3,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CIMMacro(MacroConfig(nbits=2, burn_in=1)).sample(prng.PRNGKey(0), fn, 64)


@partitionable
@pytest.mark.parametrize("maxval,dtype", [(1 << 8, "uint32"), (1 << 31, "int32"),
                                          (1 << 31, "uint32"), (2**32 - 1, "uint32"),
                                          (5, "int32")])
def test_randint_bounds_match_jax(maxval, dtype):
    """``prng.randint`` with the shim's uint32 init draw, and a maxval
    above the dtype's range (JAX widens the span by one); JAX takes a
    bound above 2^31 - 1 as a uint32 scalar."""
    jkey = jax.random.PRNGKey(maxval % 1000)
    want = jax.random.randint(jkey, (3, 50), 0, np.uint32(maxval), dtype=getattr(jnp, dtype))
    got = prng.randint(_key(jkey), (3, 50), 0, maxval, dtype=dtype)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
