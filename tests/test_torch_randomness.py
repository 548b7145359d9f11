"""The port's randomness backends and targets against the JAX package, at
tolerance 0: chain/step keys, the three ``chunk`` streams at offset
starts (with ``need_flips=False``), and the table/top-k lookups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro.samplers import randomness as jrand
from repro_torch import prng
from repro_torch import samplers as ts
from repro_torch.samplers import randomness as trand

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _eq(jax_value, torch_value):
    a = np.asarray(jax_value)
    b = torch_value.numpy()
    if a.dtype.kind in "ui":
        a = a.astype(np.int64)
    np.testing.assert_array_equal(a, b)


@partitionable
def test_chain_and_step_keys():
    k, tk = jax.random.PRNGKey(12), prng.PRNGKey(12)
    _eq(jrand.chain_key(k, 5), trand.chain_key(tk, 5))
    _eq(jrand.chain_keys(k, 4, base=3), trand.chain_keys(tk, 4, base=3))
    _eq(jrand.step_keys(k, 9, 6), trand.step_keys(tk, 9, 6))


@partitionable
@pytest.mark.parametrize("name", ["host", "cim", "fused"])
@pytest.mark.parametrize("start,nbits", [(0, 9), (13, 16), (2**31 - 3, 32)])
def test_chunk_streams(name, start, nbits):
    kw = dict(p_bfr=0.4, rng_p_bfr=0.45, rng_bit_width=12, rng_stages=2)
    jb = jrand.make_randomness_backend(name, **kw)
    tb = trand.make_randomness_backend(name, **kw)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    tkey = trand.chain_key(prng.PRNGKey(2), 1)
    shape = (3, 5)
    jf, ju = jb.chunk(key, start, 4, shape, nbits)
    tf, tu = tb.chunk(tkey, start, 4, shape, nbits)
    _eq(jf, tf)
    _eq(ju, tu)
    assert tf.shape == tu.shape == (4, *shape)
    none, lean = tb.chunk(tkey, start, 4, shape, nbits, need_flips=False)
    assert none is None
    assert torch.equal(lean, tu)


@pytest.mark.parametrize("name", ["host", "cim", "fused"])
@pytest.mark.parametrize("start", [0, 13, 2**31 - 3])
def test_tensor_start_draws_what_an_int_start_draws(name, start):
    """A 0-d int64 tensor start (a step base held on the card, never read
    on the host) draws the int start's operands bit for bit."""
    tb = trand.make_randomness_backend(name, p_bfr=0.4, rng_p_bfr=0.45, rng_bit_width=12,
                                       rng_stages=2)
    key = trand.chain_key(prng.PRNGKey(2), 1)
    t = torch.tensor(start, dtype=torch.int64)
    assert torch.equal(trand.step_keys(key, t, 6), trand.step_keys(key, start, 6))
    for need_flips in (True, False):
        f, u = tb.chunk(key, start, 4, (3, 5), 16, need_flips=need_flips)
        tf, tu = tb.chunk(key, t, 4, (3, 5), 16, need_flips=need_flips)
        assert torch.equal(tu, u)
        assert (tf is None) == (f is None) == (not need_flips)
        assert f is None or torch.equal(tf, f)


@partitionable
def test_chunking_invariance():
    tb = trand.CIMRandomness()
    key = prng.PRNGKey(3)
    f, u = tb.chunk(key, 5, 10, (2, 3), 8)
    f1, u1 = tb.chunk(key, 5, 4, (2, 3), 8)
    f2, u2 = tb.chunk(key, 9, 6, (2, 3), 8)
    assert torch.equal(f, torch.cat([f1, f2])) and torch.equal(u, torch.cat([u1, u2]))


def test_backend_factory():
    assert isinstance(trand.make_randomness_backend("cim", 0.4), ts.CIMRandomness)
    assert trand.make_randomness_backend("cim", 0.4).rng_p_bfr == 0.4
    assert isinstance(trand.make_randomness_backend("fused", 0.4), ts.RandomnessBackend)
    with pytest.raises(ValueError):
        trand.make_randomness_backend("hw", 0.4)


class TestTargets:
    def test_table_lookup_out_of_support(self):
        rs = np.random.default_rng(0)
        table = rs.normal(size=(3, 37)).astype(np.float32)  # V not a power of 2
        words = rs.integers(0, 64, size=(3, 11)).astype(np.uint32)
        jt, tt = js.TableTarget(table), ts.TableTarget(torch.from_numpy(table))
        assert jt.nbits == tt.nbits == 6
        _eq(jt.log_prob(jnp.asarray(words)), tt.log_prob(torch.from_numpy(words.astype(np.int64))))
        chains = np.stack([words, words[:, ::-1]])
        assert torch.equal(
            tt.log_prob(torch.from_numpy(chains.astype(np.int64)))[1],
            tt.log_prob(torch.from_numpy(words[:, ::-1].astype(np.int64))),
        )
        with pytest.raises(ValueError):
            ts.TableTarget(torch.zeros(3))

    def test_top_k_with_ties(self):
        logits = np.array(
            [[1.0, 3.0, 3.0, 0.5, 3.0, -1.0, 2.0], [0.0] * 7], dtype=np.float32
        )
        for k in (1, 3, 4, 7):
            jt = js.TopKTarget(logits, k, temperature=0.7)
            tt = ts.TopKTarget(torch.from_numpy(logits), k, temperature=0.7)
            _eq(jt.table, tt.table)
            _eq(jt.top_idx, tt.top_idx)
            words = np.arange(k, dtype=np.uint32)[None, :].repeat(2, 0)
            _eq(jt.decode(jnp.asarray(words)), tt.decode(torch.from_numpy(words.astype(np.int64))))
        with pytest.raises(ValueError):
            ts.TopKTarget(torch.from_numpy(logits), 8)

    @pytest.mark.parametrize("temperature", [1.0, 0.7, 1.3])
    def test_logits_target(self, temperature):
        logits = np.random.default_rng(1).normal(size=(2, 50)).astype(np.float32) * 4
        _eq(
            js.logits_target(logits, temperature).table,
            ts.logits_target(torch.from_numpy(logits), temperature).table,
        )

    def test_callable_target(self):
        t = ts.CallableTarget(lambda w: -w.to(torch.float32), nbits=4)
        assert t.table is None
        assert t.log_prob(torch.tensor([2])).item() == -2.0
        with pytest.raises(ValueError):
            ts.CallableTarget(lambda w: w, nbits=33)
