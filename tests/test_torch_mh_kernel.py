"""The MH chain kernels: their plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU) at tolerance 0, the wrappers'
input checks, and — on a card — each CUDA kernel against its plain
version.

Parity contract: chain states and accept counts are equal exactly; the
one allowed exception is a tie event (``u`` within one ULP of the accept
threshold ``exp(min(Δ, 0))``), and every test asserts that its seed has
none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mh import mh as jmh
from repro.kernels.mh import ops as jops
from repro_torch.kernels import rng
from repro_torch.kernels.mh import mh, ops, ref


def _case(seed, b, v, c, k, nbits):
    rs = np.random.default_rng(seed)
    table = (rs.normal(size=(b, v)) * 3).astype(np.float32)
    init = rs.integers(0, v, size=(b, c)).astype(np.uint32)
    flips = rs.integers(0, 2**nbits, size=(k, b, c), dtype=np.uint64).astype(np.uint32)
    # most proposals stay near the support, so wide words still accept
    flips = np.where(rs.random(flips.shape) < 0.7, flips & 0x7F, flips)
    # u on the cim grid (16 bits), with zeros and near-ones included
    u = (rs.integers(0, 2**16, size=(k, b, c)) / 2**16).astype(np.float32)
    return table, init, flips, u


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "ui" else x)


def _assert_no_ties(table, init, flips, u, nbits):
    ties = ref.tie_events(_t(table), _t(init), _t(flips), _t(u), nbits)
    assert ties.shape[0] == 0, f"tie events at (k, b, c) = {ties.tolist()}"


@pytest.mark.parametrize(
    "b,v,c,k,nbits",
    [(2, 37, 13, 24, 6), (3, 300, 5, 32, 16), (1, 129, 16, 17, 4), (2, 97, 3, 9, 32)],
)
def test_operand_kernel_matches_pallas(b, v, c, k, nbits):
    table, init, flips, u = _case(b * v + c, b, v, c, k, nbits)
    _assert_no_ties(table, init, flips, u, nbits)
    js, ja = jmh.mh_chain_pallas(
        jnp.asarray(table), jnp.asarray(init), jnp.asarray(flips), jnp.asarray(u),
        nbits=nbits, block_c=c, interpret=True,
    )
    ts_, ta = mh.mh_chain(_t(table), _t(init), _t(flips), _t(u), nbits)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert ta.dtype == torch.int32 and ts_.dtype == torch.int64
    assert 0 < int(ta.sum()) < k * b * c


@pytest.mark.parametrize(
    "b,v,c,k,nbits,cc",
    [(3, 300, 5, 16, 16, 5), (1, 129, 9, 11, 4, 3), (2, 97, 3, 7, 32, 3)],
)
def test_fused_kernel_matches_pallas(b, v, c, k, nbits, cc):
    rs = np.random.default_rng(c * v)
    table = (rs.normal(size=(b, v)) * 3).astype(np.float32)
    init = rs.integers(0, v, size=(b, c)).astype(np.uint32)
    k0c = rs.integers(0, 2**32, size=c, dtype=np.uint64).astype(np.uint32)
    k1c = rs.integers(0, 2**32, size=c, dtype=np.uint64).astype(np.uint32)
    t0c = rs.integers(0, 2**31 - 1, size=c).astype(np.int32)
    t0c[0] = 2**31 - 3  # the step counter wraps inside the chunk
    p = 0.45
    flips, u = ref.fused_operands(
        _t(k0c), _t(k1c), _t(t0c), rows=b, nbits=nbits, n_steps=k, cc=cc,
        p_u32=rng.threshold_u32(p),
    )
    _assert_no_ties(table, init, flips.numpy(), u.numpy(), nbits)
    js, ja = jops.mh_sample_fused(
        jnp.asarray(table), jnp.asarray(init), jnp.asarray(k0c), jnp.asarray(k1c),
        n_steps=k, t0=jnp.asarray(t0c), nbits=nbits, p_bfr=p, cc=cc,
    )
    ts_, ta = ops.mh_sample_fused(
        _t(table), _t(init), _t(k0c), _t(k1c), n_steps=k, t0=_t(t0c), nbits=nbits,
        p_bfr=p, cc=cc,
    )
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


@pytest.mark.parametrize("t0", [2**31 - 3, "per-column"])
def test_sample_fused_t0_int_or_per_column(monkeypatch, t0):
    """``mh_sample_fused`` takes an int step base (filled in on the device,
    never copied from the host) or a per-column tensor, as the JAX entry
    point does."""
    b, v, c, k, nbits, cc = 2, 200, 12, 9, 8, 4
    rs = np.random.default_rng(41)
    table = (rs.normal(size=(b, v)) * 3).astype(np.float32)
    init = rs.integers(0, v, size=(b, c)).astype(np.uint32)
    k0c, k1c = (rs.integers(0, 2**32, size=c, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    if t0 == "per-column":
        t0 = rs.integers(2**31 - 9, 2**31, size=c).astype(np.int32)
        jt0, tt0 = jnp.asarray(t0), _t(t0)
    else:
        jt0 = tt0 = t0
        real = torch.as_tensor

        def no_host_copy(x, *a, **kw):
            assert not isinstance(x, int), "an int t0 went through a host copy"
            return real(x, *a, **kw)

        monkeypatch.setattr(ops.torch, "as_tensor", no_host_copy)
    js, ja = jops.mh_sample_fused(
        jnp.asarray(table), jnp.asarray(init), jnp.asarray(k0c), jnp.asarray(k1c),
        n_steps=k, t0=jt0, nbits=nbits, p_bfr=0.45, cc=cc,
    )
    ts_, ta = ops.mh_sample_fused(
        _t(table), _t(init), _t(k0c), _t(k1c), n_steps=k, t0=tt0, nbits=nbits,
        p_bfr=0.45, cc=cc,
    )
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


def test_words_past_2_31_carry_through():
    """The wrappers' int64 contract: uint32 words held in int64, values at
    and past 2^31 carried through unchanged (a word outside the table has
    log-prob -inf until a finite move), samples int64 (K, B, C), accept
    int32 (B, C); equal to the Pallas kernel on the same uint32 words."""
    b, v, c, k, nbits = 2, 50, 6, 12, 32
    rs = np.random.default_rng(7)
    table = (rs.normal(size=(b, v)) * 3).astype(np.float32)
    init = rs.integers(0, v, size=(b, c)).astype(np.uint32)
    init[0, :3] = [2**31, 2**32 - 1, 2**31 + 5]
    flips = np.zeros((k, b, c), np.uint32)
    flips[5, 0, 1] = (2**32 - 1) ^ 7  # to word 7, inside the table
    flips[3, 1, 2] = 2**31  # out of the table: rejected
    u = rs.random(size=(k, b, c)).astype(np.float32)
    js, ja = jmh.mh_chain_pallas(
        jnp.asarray(table), jnp.asarray(init), jnp.asarray(flips), jnp.asarray(u),
        nbits=nbits, block_c=c, interpret=True,
    )
    ts_, ta = mh.mh_chain(_t(table), _t(init), _t(flips), _t(u), nbits)
    assert ts_.dtype == torch.int64 and tuple(ts_.shape) == (k, b, c)
    assert ta.dtype == torch.int32 and tuple(ta.shape) == (b, c)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert ts_[:, 0, 0].tolist() == [2**31] * k
    assert ts_[:5, 0, 1].tolist() == [2**32 - 1] * 5 and ts_[5:, 0, 1].tolist() == [7] * 7
    assert int(ts_.max()) == 2**32 - 1 and int(ts_.min()) >= 0


def test_denormal_accept_is_rejected():
    """Δ ≈ -95 with u = 0: exp(Δ) is a denormal, which XLA flushes to 0,
    so the step must be rejected — in the JAX kernel and in the port."""
    table = np.array([[0.0, -95.0, -87.0, 5.0]], dtype=np.float32)
    init = np.zeros((1, 3), np.uint32)
    flips = np.array([[[1, 2, 3]]], np.uint32)  # to -95, -87 and +5
    u = np.zeros((1, 1, 3), np.float32)
    js, ja = jmh.mh_chain_pallas(
        jnp.asarray(table), jnp.asarray(init), jnp.asarray(flips), jnp.asarray(u),
        nbits=2, block_c=3, interpret=True,
    )
    ts_, ta = mh.mh_chain(_t(table), _t(init), _t(flips), _t(u), 2)
    assert np.asarray(ja).tolist() == ta.tolist() == [[0, 1, 1]]
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())


def test_tie_events_are_reported():
    table = np.array([[0.0, -0.5]], dtype=np.float32)
    e = torch.exp(torch.tensor(-0.5)).item()
    u = np.array([[[e]]], np.float32)
    ties = ref.tie_events(_t(table), _t(np.zeros((1, 1), np.uint32)), _t(np.ones((1, 1, 1), np.uint32)), _t(u), 1)
    assert ties.tolist() == [[0, 0, 0]]


class TestWrapperChecks:
    def _args(self):
        table, init, flips, u = _case(0, 2, 10, 3, 4, 4)
        return _t(table), _t(init), _t(flips), _t(u)

    def test_cpu_tensors_take_the_plain_version(self):
        mh.reset_launches()
        table, init, flips, u = self._args()
        s, a = mh.mh_chain(table, init, flips, u, 4)
        r = ref.mh_chain_ref(table, init, flips, u, 4)
        assert torch.equal(s, r[0]) and torch.equal(a, r[1])
        assert mh.LAUNCHES == {"mh_chain": 0, "mh_chain_fused": 0}

    @pytest.mark.parametrize("bad", ["table_dtype", "u_dtype", "shape", "nbits", "strided"])
    def test_rejects(self, bad):
        table, init, flips, u = self._args()
        nbits = 4
        if bad == "table_dtype":
            table = table.double()
        elif bad == "u_dtype":
            u = u.double()
        elif bad == "shape":
            flips = flips[:, :1]
        elif bad == "nbits":
            nbits = 33
        else:
            table = table.t().contiguous().t()
        with pytest.raises(ValueError):
            mh.mh_chain(table, init, flips, u, nbits)

    @pytest.mark.parametrize("name", ["init", "flips"])
    def test_rejects_int32_words(self, name):
        args = dict(zip(("table", "init", "flips", "u"), self._args()))
        args[name] = args[name].to(torch.int32)
        with pytest.raises(ValueError, match=name):
            mh.mh_chain(*args.values(), 4)

    @pytest.mark.parametrize("name", ["init", "k0c", "k1c", "t0c"])
    def test_fused_rejects_int32_words(self, name):
        table, init, _, _ = self._args()
        cols = {n: torch.zeros(3, dtype=torch.int64) for n in ("k0c", "k1c", "t0c")}
        args = dict(init=init, **cols)
        args[name] = args[name].to(torch.int32)
        with pytest.raises(ValueError, match=name):
            mh.mh_chain_fused(table, *args.values(), nbits=4, n_steps=2, cc=3, p_u32=7)

    def test_fused_rejects_bad_cc(self):
        table, init, _, _ = self._args()
        cols = torch.zeros(3, dtype=torch.int64)
        with pytest.raises(ValueError):
            mh.mh_chain_fused(table, init, cols, cols, cols, nbits=4, n_steps=2, cc=4, p_u32=7)

    def test_hwprng_guard(self):
        with pytest.raises(NotImplementedError):
            mh.mh_chain_pallas_hwprng()


# --- the kernel-level entry points of ops.py --------------------------------


def test_block_c_is_accepted_and_ignored():
    """The JAX callers pass ``block_c``; the CUDA tile is chosen in the
    kernel, so the result does not depend on it."""
    table, init, flips, u = (_t(x) for x in _case(5, 2, 40, 7, 6, 6))
    base = ops.mh_sample(table, init, flips, u, nbits=6)
    for block_c in (None, 128, 256, 3):
        got = ops.mh_sample(table, init, flips, u, nbits=6, block_c=block_c)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    cols = torch.arange(7, dtype=torch.int64)
    kw = dict(n_steps=5, t0=3, nbits=6, p_bfr=0.45, cc=7)
    base = ops.mh_sample_fused(table, init, cols, cols + 9, **kw)
    got = ops.mh_sample_fused(table, init, cols, cols + 9, block_c=512, **kw)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


@pytest.mark.parametrize("k,b,c,p,stages", [(6, 2, 5, 0.45, 3), (3, 1, 9, 0.4, 2)])
def test_generate_randomness_matches_jax(k, b, c, p, stages):
    import jax

    got = ops.generate_randomness(_t(np.array([0, 31], np.uint32)), k, b, c, p, stages)
    want = jops.generate_randomness(jax.random.PRNGKey(31), k, b, c, p, stages)
    assert isinstance(got, ops.MHRandomness) and ops.MHRandomness._fields == ("flips", "u")
    np.testing.assert_array_equal(np.asarray(want.flips).astype(np.int64), got.flips.numpy())
    np.testing.assert_array_equal(np.asarray(want.u), got.u.numpy())
    assert got.flips.dtype == torch.int64 and got.u.dtype == torch.float32
    assert tuple(got.u.shape) == (k, b, c) and int(got.flips.max()) >= 2**16  # 32-bit words


@pytest.mark.parametrize("v,chains,nbits,with_init", [(37, 4, None, False), (300, 3, 10, True)])
def test_mh_sample_with_rng_matches_jax(v, chains, nbits, with_init):
    """The operand block of ``generate_randomness``, the argmax init and
    ``nbits = ceil(log2 V)``, run through the Pallas kernel (interpret
    mode) on the JAX side and the kernel's plain version here."""
    import jax

    b, k = 2, 10
    rs = np.random.default_rng(v)
    table = (rs.normal(size=(b, v)) * 3).astype(np.float32)
    init = rs.integers(0, v, size=(b, chains)).astype(np.uint32) if with_init else None
    bits = nbits or max(1, int(np.ceil(np.log2(v))))
    rnd = ops.generate_randomness(_t(np.array([0, 44], np.uint32)), k, b, chains, 0.45)
    start = init if with_init else np.broadcast_to(np.argmax(table, -1)[:, None], (b, chains))
    _assert_no_ties(table, np.asarray(start, np.uint32), rnd.flips.numpy().astype(np.uint32),
                    rnd.u.numpy(), bits)
    js, ja = jops.mh_sample_with_rng(
        jax.random.PRNGKey(44), jnp.asarray(table), k, chains=chains,
        init=None if init is None else jnp.asarray(init), nbits=nbits,
    )
    ts_, ta = ops.mh_sample_with_rng(
        _t(np.array([0, 44], np.uint32)), _t(table), k, chains=chains,
        init=None if init is None else _t(init), nbits=nbits,
    )
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    # the same as mh_sample on generate_randomness's block
    s2, a2 = ops.mh_sample(_t(table), _t(np.asarray(start, np.uint32)), rnd.flips, rnd.u, bits)
    assert torch.equal(s2, ts_) and torch.equal(a2, ta)


@pytest.mark.parametrize("temperature,prev", [(1.0, False), (0.7, True)])
def test_sample_tokens_fused_matches_jax(temperature, prev):
    """One chain per row through an engine with ``execution="pallas"``;
    the rate against JAX's eager submit (the port divides, as it does)."""
    import jax

    b, v = 3, 50
    rs = np.random.default_rng(8)
    logits = (rs.normal(size=(b, v)) * 2).astype(np.float32)
    prev_tokens = rs.integers(0, v, size=b).astype(np.int32) if prev else None
    jtok, jrate = jops.sample_tokens_fused(
        jax.random.PRNGKey(5), jnp.asarray(logits), n_steps=16, temperature=temperature,
        prev_tokens=None if prev_tokens is None else jnp.asarray(prev_tokens),
    )
    ttok, trate = ops.sample_tokens_fused(
        _t(np.array([0, 5], np.uint32)), torch.from_numpy(logits), n_steps=16,
        temperature=temperature,
        prev_tokens=None if prev_tokens is None else torch.from_numpy(prev_tokens),
        device="cpu",
    )
    assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (b,)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    assert float(trate) == float(jrate)


def test_sample_tokens_fused_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sample_tokens_fused(_t(np.array([0, 5], np.uint32)), torch.zeros(2, 8))
