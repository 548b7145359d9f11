"""The port's paper core — MSXOR, the bitcell model and the accurate
[0,1] RNG — against the JAX package, at tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitcell as jbitcell
from repro.core import msxor as jmsxor
from repro.core import uniform_rng as juniform
from repro_torch import prng
from repro_torch.core import bitcell, msxor, uniform_rng

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _eq(jax_value, torch_value):
    a = np.asarray(jax_value)
    b = torch_value.numpy() if isinstance(torch_value, torch.Tensor) else torch_value
    if a.dtype.kind in "ui":
        a = a.astype(np.int64)
        b = np.asarray(b).astype(np.int64)
    np.testing.assert_array_equal(a, b)


class TestMSXOR:
    @pytest.mark.parametrize("p", [0.1, 0.4, 0.45, 0.5])
    def test_analytics(self, p):
        for n in range(6):
            assert msxor.lambda_recursion(p, n) == jmsxor.lambda_recursion(p, n)
            assert msxor.debias_error(p, n) == jmsxor.debias_error(p, n)
        assert msxor.required_stages(p) == jmsxor.required_stages(p)

    def test_required_stages_raises(self):
        with pytest.raises(ValueError):
            msxor.required_stages(0.001, tol=1e-12, max_stages=3)

    @pytest.mark.parametrize("n_stages,axis", [(1, -1), (3, -2), (2, 0)])
    def test_xor_fold(self, n_stages, axis):
        rs = np.random.default_rng(n_stages)
        shape = [3, 5, 7]
        shape[axis] = 1 << n_stages
        raw = rs.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        _eq(
            jmsxor.xor_fold(jnp.asarray(raw), n_stages=n_stages, axis=axis),
            msxor.xor_fold(torch.from_numpy(raw.astype(np.int64)), n_stages, axis),
        )
        with pytest.raises(ValueError):
            msxor.xor_fold(torch.zeros(3, 3, dtype=torch.int64), n_stages, axis=-1)

    def test_bits_pack_unpack(self):
        rs = np.random.default_rng(1)
        raw = rs.integers(0, 2, size=(4, 8, 13), dtype=np.uint8)
        _eq(jmsxor.debias_bits(jnp.asarray(raw)), msxor.debias_bits(torch.from_numpy(raw)))
        bits = rs.integers(0, 2, size=(5, 32), dtype=np.uint8)
        words = msxor.pack_bits_to_uint(torch.from_numpy(bits), 32)
        _eq(jmsxor.pack_bits_to_uint(jnp.asarray(bits), 32), words)
        _eq(jmsxor.unpack_uint_to_bits(jnp.asarray(np.asarray(words, np.uint32)), 32),
            msxor.unpack_uint_to_bits(words, 32))


class TestBitcell:
    def test_curves(self):
        cvdd = np.linspace(0.2, 0.9, 1401).astype(np.float32)
        temp = np.linspace(-60.0, 100.0, 641).astype(np.float32)
        _eq(jbitcell.bfr_vs_cvdd(cvdd), bitcell.bfr_vs_cvdd(cvdd))
        _eq(jbitcell.temperature_factor(temp), bitcell.temperature_factor(temp))
        _eq(
            jbitcell.bit_flip_rate(cvdd[::20, None], temp[None, ::20]),
            bitcell.bit_flip_rate(cvdd[::20, None], temp[None, ::20]),
        )
        for cv, tc in ((0.5, 25.0), (0.55, 30.0), (0.42, -30.0)):
            assert (
                bitcell.BitcellConfig(cv, tc).p_bfr
                == jbitcell.BitcellConfig(cv, tc).p_bfr
            )

    @partitionable
    def test_pseudo_reads(self):
        k, tk = jax.random.PRNGKey(4), prng.PRNGKey(4)
        _eq(
            jbitcell.pseudo_read_fresh(k, 0.45, shape=(3, 8, 5)),
            bitcell.pseudo_read_fresh(tk, 0.45, shape=(3, 8, 5)),
        )
        for nbits in (1, 7, 32):
            _eq(
                jbitcell.raw_random_words(k, 0.4, (3, 5), nbits=nbits),
                bitcell.raw_random_words(tk, 0.4, (3, 5), nbits=nbits),
            )
        with pytest.raises(ValueError):
            bitcell.raw_random_words(tk, 0.4, (3,), nbits=33)


@partitionable
class TestUniformRNG:
    @pytest.mark.parametrize("bit_width,n_stages", [(8, 3), (16, 3), (32, 2)])
    def test_uniform(self, bit_width, n_stages):
        k, tk = jax.random.PRNGKey(6), prng.PRNGKey(6)
        _eq(
            juniform.uniform_words(k, (4, 7), 0.45, bit_width, n_stages),
            uniform_rng.uniform_words(tk, (4, 7), 0.45, bit_width, n_stages),
        )
        _eq(
            juniform.uniform(k, (4, 7), 0.45, bit_width, n_stages),
            uniform_rng.uniform(tk, (4, 7), 0.45, bit_width, n_stages),
        )

    def test_batched_keys(self):
        k, tk = jax.random.PRNGKey(8), prng.PRNGKey(8)
        ks = jax.random.split(k, 3)
        _eq(
            jax.vmap(lambda kk: juniform.uniform(kk, (2, 5), 0.45, 16, 3))(ks),
            uniform_rng.uniform(prng.split(tk, 3), (2, 5), 0.45, 16, 3),
        )

    @pytest.mark.parametrize("seed,draws", [(10, [(), (3, 4), (7,)]), (2**31 + 3, [(2, 2, 5)] * 3)])
    def test_accurate_uniform_rng(self, seed, draws):
        """The stateful wrapper's n-th draw equals JAX's n-th draw: each
        draw splits the key the same way."""
        cfg = dict(p_bfr=0.4, n_stages=3, bit_width=16)
        jr = juniform.AccurateUniformRNG(jax.random.PRNGKey(seed), juniform.UniformRNGConfig(**cfg))
        tr = uniform_rng.AccurateUniformRNG(prng.PRNGKey(seed), uniform_rng.UniformRNGConfig(**cfg))
        for shape in draws:
            got = tr.draw(shape)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            _eq(jr.draw(shape), got)


class TestPaperCoreLeftovers:
    @partitionable
    @pytest.mark.parametrize("shape,p", [((4, 33), 0.45), ((2, 3, 16), 0.1), ((1,), 0.5)])
    def test_pseudo_read_flip(self, shape, p):
        rs = np.random.default_rng(len(shape))
        stored = rs.integers(0, 2, size=shape).astype(np.uint8)
        got = bitcell.pseudo_read_flip(prng.PRNGKey(9), torch.from_numpy(stored), p)
        want = jbitcell.pseudo_read_flip(jax.random.PRNGKey(9), jnp.asarray(stored), p)
        assert got.dtype == torch.uint8 and np.asarray(want).dtype == np.uint8
        _eq(want, got)
        # the flips are the Bernoulli draw of the fresh pseudo-read
        _eq(jbitcell.pseudo_read_fresh(jax.random.PRNGKey(9), p, shape=shape),
            got ^ torch.from_numpy(stored))

    @pytest.mark.parametrize("kind", ["numpy", "tensor", "list"])
    def test_empirical_lambda(self, kind):
        bits = np.random.default_rng(3).integers(0, 2, size=(17, 29)).astype(np.uint8)
        arg = {"numpy": bits, "tensor": torch.from_numpy(bits), "list": bits.tolist()}[kind]
        got = msxor.empirical_lambda(arg)
        assert isinstance(got, float) and got == jmsxor.empirical_lambda(bits)
