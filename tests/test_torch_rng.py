"""The port's counter cipher and ``jax.random`` subset against the JAX
package, at tolerance 0.

``repro_torch.kernels.rng`` must reproduce ``repro.kernels.rng`` word for
word (and the Random123 known answers), and ``repro_torch.prng`` the
``jax.random`` functions the streams pass through, for the partitionable
Threefry layout that the installed jax uses by default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro_torch import prng
from repro_torch.kernels import _build
from repro_torch.kernels import rng as trng

KAT = [  # Random123 Threefry-2x32-20 known-answer vectors: key, counter, out
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(jax_value, torch_value):
    np.testing.assert_array_equal(
        np.asarray(jax_value).astype(np.int64)
        if np.asarray(jax_value).dtype.kind in "ui" else np.asarray(jax_value),
        torch_value.numpy() if isinstance(torch_value, torch.Tensor) else torch_value,
    )


class TestCipher:
    @pytest.mark.parametrize("key,ctr,out", KAT)
    def test_known_answers(self, key, ctr, out):
        assert trng.threefry2x32(*key, *ctr) == out
        y = trng.threefry2x32(*(torch.tensor([v]) for v in (*key, *ctr)))
        assert (int(y[0]), int(y[1])) == out

    def test_random_counters_match_jax(self):
        k0, k1, x0, x1 = (_words(s, (257,)) for s in range(4))
        j = jrng.threefry2x32(*(jnp.asarray(a, jnp.uint32) for a in (k0, k1, x0, x1)))
        t = trng.threefry2x32(*(_t(a) for a in (k0, k1, x0, x1)))
        _eq(j[0], t[0])
        _eq(j[1], t[1])

    def test_draws_match_jax(self):
        k0, k1 = (int(w) for w in _words(7, (2,)))
        shape = (3, 5)
        t = np.arange(4, dtype=np.uint32)[:, None, None] + np.uint32(2**32 - 2)
        js0, js1 = jrng.step_key(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(t))
        ts0, ts1 = trng.step_key(k0, k1, _t(t))
        _eq(js0, ts0)
        _eq(js1, ts1)
        jsite, tsite = jrng.site_index(shape), trng.site_index(shape)
        _eq(jsite, tsite)
        _eq(jrng.uniform_at(js0, js1, jsite), trng.uniform_at(ts0, ts1, tsite))
        for nbits, p in ((4, 0.45), (16, 0.3), (32, 0.5)):
            p_u32 = jrng.threshold_u32(p)
            assert p_u32 == trng.threshold_u32(p)
            _eq(
                jrng.flips_at(js0, js1, jsite, nbits, p_u32),
                trng.flips_at(ts0, ts1, tsite, nbits, p_u32),
            )
        assert (trng.U_SALT, trng.FLIP_SALT) == (jrng.U_SALT, jrng.FLIP_SALT)

    def test_threshold_edges(self):
        for p in (0.0, 1e-12, 0.45, 1.0, 1.5, -0.1):
            assert trng.threshold_u32(p) == jrng.threshold_u32(p)


class TestU32Bits:
    def test_round_trip_all_bit_patterns(self):
        words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF])
        bits = _build.to_u32_bits(words)
        assert bits.dtype == torch.int32
        assert bits.tolist() == [0, 1, 2**31 - 1, -(2**31), -1, 0xDEADBEEF - 2**32]
        assert _build.from_u32_bits(bits).tolist() == words.tolist()
        # the int32 bit pattern is the uint32 word, as the kernel reads it
        np.testing.assert_array_equal(
            bits.numpy().view(np.uint32), words.numpy().astype(np.uint32)
        )


@partitionable
class TestPRNG:
    @pytest.mark.parametrize("seed", [0, 5, 2**31 - 1, 2**32 + 3])
    def test_prng_key(self, seed):
        _eq(jax.random.PRNGKey(seed), prng.PRNGKey(seed))

    def test_fold_in_and_split(self):
        k, tk = jax.random.PRNGKey(42), prng.PRNGKey(42)
        for d in (0, 7, 2**31 - 1):
            _eq(jax.random.fold_in(k, d), prng.fold_in(tk, d))
        ds = jnp.arange(5, dtype=jnp.int32) + 11
        _eq(jax.vmap(lambda d: jax.random.fold_in(k, d))(ds), prng.fold_in(tk, _t(ds)))
        for n in (2, 3, 7):
            _eq(jax.random.split(k, n), prng.split(tk, n))

    @pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 7), (2, 1, 9, 4)])
    def test_draws(self, shape):
        k, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
        _eq(jax.random.bits(k, shape), prng.bits(tk, shape))
        _eq(jax.random.uniform(k, shape), prng.uniform(tk, shape))
        _eq(jax.random.bernoulli(k, 0.45, shape), prng.bernoulli(tk, 0.45, shape))

    def test_batched_keys(self):
        k, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
        ks = jax.random.split(k, 4)
        tks = prng.split(tk, 4)
        _eq(jax.vmap(lambda kk: jax.random.uniform(kk, (3, 2)))(ks), prng.uniform(tks, (3, 2)))
        _eq(
            jax.vmap(lambda kk: jax.random.bernoulli(kk, 0.3, (5,)))(ks),
            prng.bernoulli(tks, 0.3, (5,)),
        )
