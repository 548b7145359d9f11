"""The port's ``gmm`` workload against the JAX package's
(``tests/test_workloads.py::TestGMMWorkload`` and the builder's
contract).

The workload is MH over a (1, 256) table of the paper's Fig. 17(a)
mixture.  Two tables are held:

  * the JAX table carried across (``convert.table_target_from_numpy``):
    the chains, accept counts, rates and final log-probs equal the JAX
    run's at tolerance 0 — the MH parity contract of slice 1;
  * the port's own table: within ``GMM_ULPS`` = 1 ULP of the JAX table
    (``log`` differs by an ULP between XLA and PyTorch), and the chains
    equal the JAX run's except at tie events; each seed is asserted to
    have none within ``TIE_ULPS`` = 4 ULP of each log-prob.

The JAX side runs its Pallas executor in interpret mode; the port's
``pallas`` executor runs the MH kernels' plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as jw
from repro.core import targets as jtargets
from repro.workloads import gmm as jgmm
from repro_torch import convert, samplers, workloads
from repro_torch.core import targets
from repro_torch.kernels.mh import mh, ref
from repro_torch.workloads import gmm

GMM_ULPS = 1
TIE_ULPS = 4
KEY = np.array([0, 5], np.uint32)
RUN_KEY = np.asarray(jax.random.PRNGKey(4))
FIELDS = ("samples", "accept_count", "final_words", "final_logp")

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


def _run_key():
    return convert.key_from_numpy(RUN_KEY, "cpu")


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}

    def get(randomness, backend):
        if (randomness, backend) not in runs:
            wl = jw.build("gmm", jnp.asarray(KEY), smoke=True, randomness=randomness,
                          backend=backend)
            res = wl.run(jnp.asarray(RUN_KEY))
            runs[randomness, backend] = (
                np.asarray(wl.target.table), {f: np.asarray(getattr(res, f)) for f in FIELDS},
                np.float32(res.acceptance_rate),
            )
        return runs[randomness, backend]

    return get


def _assert_no_ties(wl, randomness):
    """Replay the run with the port's operands and its own table."""
    key = samplers.chain_key(_run_key(), 0)
    shape = tuple(wl.init_words.shape)
    flips, u = wl.engine.randomness.chunk(key, 0, wl.n_steps, shape, wl.target.nbits)
    ties = ref.tie_events(wl.target.table, wl.init_words, flips, u, wl.target.nbits,
                          logp_ulps=TIE_ULPS)
    assert ties.shape[0] == 0, f"tie events at {ties[:5].tolist()}"


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("table", ["jax", "port"])
def test_gmm_run_matches_jax(jax_runs, randomness, backend, table):
    jtable, want, jrate = jax_runs(randomness, backend)
    wl = workloads.build("gmm", KEY, smoke=True, randomness=randomness, backend=backend,
                         device="cpu")
    assert _ulps(jtable, wl.target.table.numpy()) <= GMM_ULPS
    if table == "jax":
        wl.target = convert.table_target_from_numpy(jtable, nbits=8, device="cpu")
    else:
        _assert_no_ties(wl, randomness)
    res = wl.run(_run_key())
    for f in ("samples", "accept_count", "final_words"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), want[f].astype(np.int64), f)
    if table == "jax":
        np.testing.assert_array_equal(res.final_logp.numpy(), want["final_logp"])
    else:
        assert _ulps(res.final_logp.numpy(), want["final_logp"]) <= GMM_ULPS
    assert np.float32(res.acceptance_rate.item()) == jrate


def test_scan_and_pallas_bit_identical():
    runs = {}
    for backend in ("scan", "pallas"):
        wl = workloads.build("gmm", KEY, smoke=True, backend=backend, device="cpu")
        runs[backend] = wl.run(_run_key())
    for f in FIELDS:
        assert torch.equal(getattr(runs["scan"], f), getattr(runs["pallas"], f)), f


def test_table_materialises_callable_exactly():
    """The TableTarget rows are the CallableTarget's values at every word."""
    mix, codec = gmm.default_model()
    callable_t = gmm.make_callable_target(mix, codec)
    table_t = gmm.make_table_target(mix, codec, device="cpu")
    words = torch.arange(1 << codec.nbits)[None, :]
    assert torch.equal(callable_t.log_prob(words), table_t.log_prob(words))
    assert table_t.nbits == 8 and tuple(table_t.table.shape) == (1, 256)


def test_posterior_matches_reference_grid():
    """Post burn-in histogram converges to the exact cell probabilities
    (TV distance) — the MC²RAM benchmark's correctness claim."""
    wl = workloads.build("gmm", np.asarray(jax.random.PRNGKey(1)), randomness="host",
                         backend="scan", chains=64, n_steps=1500, device="cpu")
    res = wl.run(convert.key_from_numpy(np.asarray(jax.random.PRNGKey(2)), "cpu"))
    kept = res.samples[wl.burn_in:].reshape(-1).numpy()
    emp = np.bincount(kept, minlength=256) / kept.size
    tv = 0.5 * np.abs(emp - gmm.reference_probs(8)).sum()
    assert tv < 0.08, f"TV {tv}"


@partitionable
@pytest.mark.parametrize("num_chains", [1, 3])
@pytest.mark.parametrize("kw", [dict(smoke=True), dict(nbits=6, chains=5, n_steps=40),
                                dict(nbits=12, chains=4)])
def test_build_matches_jax(kw, num_chains):
    """Inits, run length, meta, statistic and engine config equal JAX's."""
    jwl = jw.build("gmm", jnp.asarray(KEY), num_chains=num_chains, **kw)
    twl = workloads.build("gmm", KEY, num_chains=num_chains, device="cpu", **kw)
    np.testing.assert_array_equal(twl.init_words.numpy(), np.asarray(jwl.init_words))
    assert (twl.n_steps, twl.burn_in, twl.meta) == (jwl.n_steps, jwl.burn_in, jwl.meta)
    states = twl.init_words if num_chains == 1 else twl.init_words[0]
    np.testing.assert_array_equal(
        twl.series_fn(states[None]).numpy(),
        np.asarray(jwl.series_fn(jnp.asarray(states.numpy().astype(np.uint32))[None])),
    )
    assert twl.engine.config == samplers.EngineConfig(**{
        f: getattr(jwl.engine.config, f) for f in samplers.EngineConfig.__dataclass_fields__
    })


def test_build_defaults():
    wl = workloads.build("gmm", KEY, device="cpu")
    assert (wl.n_steps, wl.burn_in, tuple(wl.init_words.shape)) == (2048, 512, (1, 64))
    assert wl.engine.config.chunk_steps == 32 and wl.engine.config.randomness == "cim"
    assert wl.rate_key == "acceptance_rate"


@partitionable
@pytest.mark.parametrize("num_chains,collect", [(1, "all"), (2, "thin:3")])
def test_diagnostics_match_jax(num_chains, collect):
    kw = dict(randomness="fused", backend="pallas", smoke=True, num_chains=num_chains,
              collect=collect, n_steps=40, chunk_steps=8)
    jwl = jw.build("gmm", jnp.asarray(KEY), **kw)
    twl = workloads.build("gmm", KEY, device="cpu", **kw)
    twl.target = convert.table_target_from_numpy(np.asarray(jwl.target.table), 8, "cpu")
    jres = jwl.run(jnp.asarray(RUN_KEY))
    tres = twl.run(_run_key())
    np.testing.assert_array_equal(tres.samples.numpy(), np.asarray(jres.samples))
    np.testing.assert_array_equal(twl.series(tres), jwl.series(jres))
    assert twl.rate_entry(tres) == jwl.rate_entry(jres)
    assert twl.diagnostics(tres) == jwl.diagnostics(jres)


def test_reference_probs_match_jax():
    np.testing.assert_allclose(gmm.reference_probs(8), jgmm.reference_probs(8),
                               rtol=4 * GMM_ULPS * 2.0**-23, atol=0)
    assert gmm.reference_probs(6).shape == (64,)


def test_convert_density_helpers():
    jmix, jcodec = jgmm.default_model()
    mix = convert.gaussian_mixture_from_jax(jmix)
    codec = convert.codec_from_jax(jcodec)
    assert (mix, codec) == gmm.default_model()
    jmgd = jtargets.MultivariateGaussian.paper_mgd()
    assert convert.multivariate_gaussian_from_jax(jmgd) == targets.MultivariateGaussian.paper_mgd()
    gray = convert.codec_from_jax(jtargets.GridCodec(6, 2, (-1.0, 0.0), (1.0, 2.0), gray=True))
    assert gray == targets.GridCodec(6, 2, (-1.0, 0.0), (1.0, 2.0), gray=True)
    t = convert.table_target_from_numpy(np.zeros((1, 256), np.float32), nbits=8, device="cpu")
    assert t.nbits == 8 and t.table.dtype == torch.float32


def test_main_path_launch_counts_stay_zero_on_cpu():
    mh.reset_launches()
    for randomness in ("cim", "fused"):
        workloads.build("gmm", KEY, randomness=randomness, backend="pallas", smoke=True,
                        device="cpu").run(_run_key())
    assert mh.LAUNCHES == {"mh_chain": 0, "mh_chain_fused": 0}
