"""The port's checkerboard Gibbs kernels (plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode.

Inputs are made from a numpy seed and handed to both packages: Ising
lattices 8 x 8 and an odd 5 x 7 (two neighbours across an odd wrap share
a colour), spin glasses 4 x 4 and 6 x 8 with ±1 couplings, B = 2
lattices, K = 24 half-sweeps, a per-lattice parity and step base that
differ between the lattices.  Samples and flip counts are compared with
tolerance 0; every case asserts that its draws hold no tie event (u
within ``ref.TIE_ULPS`` ULP of the flip probability), the parity
contract's only exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gibbs import ops as jops
from repro.kernels.gibbs.gibbs import gibbs_chain_pallas, gibbs_chain_pallas_fused
from repro.workloads.ising import IsingModel as JIsing
from repro.workloads.spin_glass import SpinGlass as JGlass
from repro_torch import samplers, workloads
from repro_torch.kernels.gibbs import gibbs, ops, ref

B, K = 2, 24
CASES = [("ising", 8, 8), ("ising", 5, 7), ("spin_glass", 4, 4), ("spin_glass", 6, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's int64 Threefry runs many small element-wise ops; on a
    CPU shared by several test workers, torch's intra-op threads spin
    against each other, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(kind, h, w, seed=0):
    """(JAX logit_fn, JAX consts, port logit spec, init, u) from a seed."""
    rs = np.random.default_rng([seed, h, w])
    init = rs.integers(0, 2, size=(B, h, w)).astype(np.uint32)
    u = rs.random(size=(K, B, h, w), dtype=np.float32)
    if kind == "ising":
        model = JIsing(h, w, beta=0.4407, field=0.05)
        spec = ref.IsingLogit(0.4407, 0.05)
        fn, consts = model.conditional_logit, ()
    else:
        jr, jd = (rs.choice([-1.0, 1.0], size=(h, w)).astype(np.float32) for _ in range(2))
        model = JGlass(jr, jd, field=-0.2)
        spec = ref.SpinGlassLogit(torch.from_numpy(jr), torch.from_numpy(jd), -0.2)
        fn, consts = model.fused_logit, model.fused_consts
    return fn, consts, spec, init, u


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("kind,h,w", CASES)
def test_operand_kernel_matches_jax(kind, h, w):
    fn, consts, spec, init, u = _case(kind, h, w)
    parity0 = np.array([1, 0], np.int32)
    want_s, want_f = gibbs_chain_pallas(
        jnp.asarray(init), jnp.asarray(u), fn, parity0=jnp.asarray(parity0),
        interpret=True, consts=consts,
    )
    got_s, got_f = gibbs.gibbs_chain(_t(init), torch.from_numpy(u), spec, _t(parity0))
    assert ref.chain_ties(_t(init), torch.from_numpy(u), spec, _t(parity0)).shape[0] == 0
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_s.dtype == torch.int32 and got_f.dtype == torch.int32


@pytest.mark.parametrize("kind,h,w", CASES)
@pytest.mark.parametrize("lat_b", [1, 2])
def test_fused_kernel_matches_jax(kind, h, w, lat_b):
    fn, consts, spec, init, _ = _case(kind, h, w)
    rs = np.random.default_rng([7, h, w])
    k0b, k1b = (rs.integers(0, 2**32, size=(B,), dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    t0b = np.array([5, 2**31 - 10], np.int32)  # the second wraps past 2^31
    want_s, want_f = gibbs_chain_pallas_fused(
        jnp.asarray(init), jnp.asarray(k0b), jnp.asarray(k1b), jnp.asarray(t0b), fn,
        n_steps=K, lat_b=lat_b, interpret=True, consts=consts,
    )
    got_s, got_f = gibbs.gibbs_chain_fused(
        _t(init), _t(k0b), _t(k1b), _t(t0b), spec, n_steps=K, lat_b=lat_b
    )
    u = torch.stack([
        ref.fused_uniforms(_t(k0b), _t(k1b), _t(t0b), k, init.shape, lat_b) for k in range(K)
    ])
    assert u.unique().numel() > 0.9 * u.numel() / lat_b
    for i in range(B):  # each lattice at its own parity t0b[i] % 2
        ties = ref.chain_ties(_t(init[i:i + 1]), u[:, i:i + 1], spec, int(t0b[i]) % 2)
        assert ties.shape[0] == 0
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_s.dtype == torch.int32 and got_f.dtype == torch.int32


@pytest.mark.parametrize("kind,h,w", CASES[1:3])
def test_ops_entry_points_match_jax(kind, h, w):
    """``gibbs_sweep``/``gibbs_sweep_fused`` with int parity and step base."""
    fn, consts, spec, init, u = _case(kind, h, w, seed=3)
    want = jops.gibbs_sweep(jnp.asarray(init), jnp.asarray(u), fn, parity0=1, consts=consts)
    got = ops.gibbs_sweep(_t(init), torch.from_numpy(u), spec, parity0=1)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    k0b, k1b = np.array([1, 2], np.uint32), np.array([3, 4], np.uint32)
    want = jops.gibbs_sweep_fused(
        jnp.asarray(init), jnp.asarray(k0b), jnp.asarray(k1b), fn, n_steps=9, t0=6,
        lat_b=B, consts=consts,
    )
    got = ops.gibbs_sweep_fused(_t(init), _t(k0b), _t(k1b), spec, n_steps=9, t0=6, lat_b=B)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("kind,h,w", CASES)
def test_logit_specs_match_jax_models(kind, h, w):
    """The one conditional formula, over a batch of random states and at
    every colour, equals the JAX model's bit for bit."""
    fn, consts, spec, init, _ = _case(kind, h, w, seed=5)
    states = np.random.default_rng(1).integers(0, 2, size=(6, h, w)).astype(np.uint32)
    want = np.asarray(jax.jit(lambda s: fn(s, *consts))(jnp.asarray(states)))
    np.testing.assert_array_equal(spec(_t(states)).numpy(), want)


@pytest.mark.parametrize("beta", [0.35, 0.4407, 1.0])
def test_sigmoid_is_the_xla_formula(beta):
    """``ref.sigmoid`` is ``1 / (1 + exp(-x))``; at the lattice logits
    2 beta {-4, ..., 4} it equals jitted ``jax.nn.sigmoid`` bit for bit."""
    x = 2 * np.float32(beta) * np.arange(-4, 5, dtype=np.float32)
    got = ref.sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax.nn.sigmoid)(x)))
    xs = torch.linspace(-20, 20, 4001)
    assert torch.equal(ref.sigmoid(xs), 1.0 / (1.0 + torch.exp(-xs)))


def test_tie_events():
    """A tie is u within TIE_ULPS ULP (above p's own spacing) of p."""
    p = torch.tensor([0.25, 0.5, 0.75, 0.9], dtype=torch.float32)
    ulp = torch.nextafter(p, torch.full_like(p, 2.0)) - p
    u = torch.stack([p, p + 4 * ulp, p + 5 * ulp, p + 0.01])
    ties = ref.tie_events(u, p.expand(4, 4))
    assert ties[:, 0].tolist() == [0] * 4 + [1] * 4


def test_wrapper_validation_and_cpu_launch_counts():
    _, _, spec, init, u = _case("ising", 5, 7)
    init_t, u_t, par = _t(init), torch.from_numpy(u), torch.zeros(B, dtype=torch.int64)
    gibbs.reset_launches()
    gibbs.gibbs_chain(init_t, u_t, spec, par)
    gibbs.gibbs_chain_fused(init_t, par, par, par, spec, n_steps=3, lat_b=B)
    assert gibbs.LAUNCHES == {"gibbs_chain": 0, "gibbs_chain_fused": 0}
    with pytest.raises(ValueError, match="IsingLogit"):
        gibbs.gibbs_chain(init_t, u_t, lambda s: s, par)
    with pytest.raises(ValueError, match="u must have shape"):
        gibbs.gibbs_chain(init_t, u_t[:, :1], spec, par)
    with pytest.raises(ValueError, match="parity0"):
        gibbs.gibbs_chain(init_t, u_t, spec, par[:1])
    with pytest.raises(ValueError, match="K >= 1"):
        gibbs.gibbs_chain_fused(init_t, par, par, par, spec, n_steps=0, lat_b=B)
    with pytest.raises(ValueError, match="lat_b"):
        gibbs.gibbs_chain_fused(init_t, par, par, par, spec, n_steps=2, lat_b=3)
    glass = ref.SpinGlassLogit(torch.ones(4, 4), torch.ones(4, 4))
    with pytest.raises(ValueError, match="j_right"):
        gibbs.gibbs_chain(init_t, u_t, glass, par)


# --- the band kernel's launch plan (pure Python, what the card would run) ---

# The H100's limits as ``band_limits`` reads them from ``csrc/gibbs.cu``:
# 132 blocks a launch, and the most rows a band of each width may have
# (``band_max_rows`` with 232,400 bytes of shared memory a block).
H100_BLOCKS = 132
H100_ROWS = {1024: 112, 7: 16384, 5: 21845, 256: 452, 257: 451, 3000: 37, 3828: 29,
             3829: 29, 4096: 27, 200_000: 0}


def _assert_plan(groups, b, h, w, max_blocks, max_rows):
    """Groups cover lattices 0..B-1 once, in order (so lattice i keeps its
    site base (i % lat_b) H W), each within one cooperative launch, with
    bands that tile the lattice and fit a block."""
    covered = [i for g in groups for i in range(g.b0, g.b0 + g.lattices)]
    assert covered == list(range(b))
    sizes = [g.lattices for g in groups]
    assert max(sizes) - min(sizes) <= 1
    for g in groups:
        assert g.lattices * g.bands <= max_blocks
        assert (g.bands - 1) * g.rows < h <= g.bands * g.rows
        assert 1 <= g.rows <= max_rows


@pytest.mark.parametrize("b,h,w,n_groups,bands,rows", [
    (4, 1024, 1024, 1, 32, 32),   # the main path: 4 x 32 bands of 32 rows
    (16, 1024, 1024, 2, 16, 64),  # two launches of 8 lattices
    (3, 5, 7, 1, 5, 1),
    (1, 3, 5, 1, 3, 1),
    (8, 256, 256, 1, 16, 16),
    (2, 3000, 3000, 2, 131, 23),  # one lattice a launch
    (1, 256, 256, 1, 128, 2),     # the operand paths (host, cim): 128 bands of 2 rows
    (2, 255, 257, 1, 64, 4),      # odd periodic
])
def test_plan_groups_main_shapes(b, h, w, n_groups, bands, rows):
    limits = dict(max_blocks=H100_BLOCKS, max_rows=H100_ROWS[w])
    groups = gibbs.plan_groups(b, h, w, **limits)
    _assert_plan(groups, b, h, w, **limits)
    assert len(groups) == n_groups
    assert (groups[0].bands, groups[0].rows) == (bands, rows)


@pytest.mark.parametrize("seed", range(6))
def test_plan_groups_random_shapes(seed):
    rs = np.random.default_rng(seed)
    max_blocks = int(rs.integers(1, 300))
    for _ in range(200):
        b, h, w = (int(x) for x in (rs.integers(1, 70), rs.integers(2, 3000),
                                    rs.integers(2, 3000)))
        limits = dict(max_blocks=max_blocks, max_rows=int(rs.integers(0, 200)))
        try:
            groups = gibbs.plan_groups(b, h, w, **limits)
        except ValueError:
            rows = limits["max_rows"]
            assert rows == 0 or -(-h // rows) > max_blocks
            continue
        _assert_plan(groups, b, h, w, **limits)


def test_plan_groups_per_lattice_limit():
    """A lattice the card cannot hold in one launch raises, with the limit."""
    assert H100_BLOCKS * H100_ROWS[4096] < 4096
    with pytest.raises(ValueError, match="too large for one cooperative launch"):
        gibbs.plan_groups(1, 4096, 4096, max_blocks=H100_BLOCKS, max_rows=H100_ROWS[4096])
    with pytest.raises(ValueError, match="at most 0 rows"):
        gibbs.plan_groups(1, 4, 200_000, max_blocks=H100_BLOCKS, max_rows=H100_ROWS[200_000])
    # the largest square lattice one launch takes (README): 132 bands
    (g,) = gibbs.plan_groups(1, 3828, 3828, max_blocks=H100_BLOCKS, max_rows=H100_ROWS[3828])
    assert g.bands == H100_BLOCKS
    with pytest.raises(ValueError, match="at most 132 bands"):
        gibbs.plan_groups(1, 3829, 3829, max_blocks=H100_BLOCKS, max_rows=H100_ROWS[3829])


@pytest.mark.parametrize("num_chains,copied", [(1, False), (2, True)])
def test_engine_hands_the_drawn_uniforms_over(monkeypatch, num_chains, copied):
    """With one chain the kernel gets the (n, B, H, W) block the randomness
    backend drew, not a copy; with more, one interleaved copy."""
    drawn, given = [], []
    chunk = samplers.randomness.HostRandomness.chunk

    def record_chunk(self, *args, **kw):
        out = chunk(self, *args, **kw)
        drawn.append(out[1])
        return out

    def record_sweep(state, u, logit, parity0=0):
        given.append(u)
        return real_sweep(state, u, logit, parity0)

    real_sweep = ops.gibbs_sweep
    monkeypatch.setattr(samplers.randomness.HostRandomness, "chunk", record_chunk)
    monkeypatch.setattr(ops, "gibbs_sweep", record_sweep)
    wl = workloads.build("ising", np.array([0, 5], np.uint32), randomness="host",
                         backend="pallas", batch=2, height=5, width=7, n_steps=10,
                         chunk_steps=4, num_chains=num_chains, device="cpu")
    wl.engine.submit(wl.plan(np.array([0, 9])))
    assert len(given) == 3 and len(drawn) == 3 * num_chains
    for i, u in enumerate(given):
        assert u.is_contiguous() and u.shape == (u.shape[0], 2 * num_chains, 5, 7)
        assert (u is not drawn[i * num_chains]) == copied
        chains = torch.stack(drawn[i * num_chains:(i + 1) * num_chains], dim=1)
        assert torch.equal(u, chains.reshape(u.shape))
