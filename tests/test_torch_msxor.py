"""The port's MSXOR debias kernel entry points against the JAX package.

On the CPU the port's ``msxor_fold`` / ``msxor_uniform`` take the plain
versions (``kernels/msxor/ref.py``); the JAX entry points run the Pallas
kernel in interpret mode, as ``tests/test_kernels.py::TestMSXORKernel``
runs it.  Every comparison is at tolerance 0: the fold is integer XOR and
the uniform ``(w >> 8) * 2^-24`` is exact in float32.  The card's kernel
is held against the plain versions in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitcell as jbitcell
from repro.kernels.msxor import ops as jops
from repro.kernels.msxor.ref import msxor_fold_ref as jfold_ref
from repro_torch import convert
from repro_torch.core import bitcell
from repro_torch.kernels.msxor import msxor as kmsxor
from repro_torch.kernels.msxor import ops
from repro_torch.kernels.msxor.ref import msxor_fold_ref, msxor_uniform_ref

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _raw(seed, g, m):
    """(G, M) uint32 words from numpy, every bit pattern possible."""
    rs = np.random.default_rng(seed)
    return rs.integers(0, 2**32, size=(g, m), dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.astype(np.int64))


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [128, 500, 512, 1000, 4096])
def test_fold_matches_jax(n_stages, m):
    raw = _raw(n_stages * 1000 + m, 1 << n_stages, m)
    want = np.asarray(jops.msxor_fold(jnp.asarray(raw), n_stages=n_stages))
    got = ops.msxor_fold(_t(raw), n_stages=n_stages)
    assert got.dtype == torch.int64 and got.shape == (m,)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("m", [128, 777, 2048])
def test_uniform_matches_jax(m):
    raw = _raw(m, 8, m)
    want = np.asarray(jops.msxor_uniform(jnp.asarray(raw)))
    got = ops.msxor_uniform(_t(raw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("to_uniform", [False, True])
def test_five_stages_and_bit31(to_uniform):
    """n_stages = 5 (G = 32, the most the JAX kernel unrolls), and words
    with bit 31 set in every row, whose int32 coding is negative: the
    shift of the uniform must be logical."""
    raw = _raw(5, 32, 300) | np.uint32(0x80000000)
    raw[1:, :150] &= np.uint32(0x7FFFFFFF)  # columns < 150 keep bit 31 after the fold
    fn = jops.msxor_uniform if to_uniform else jops.msxor_fold
    want = np.asarray(fn(jnp.asarray(raw), n_stages=5))
    for coded in (_t(raw), _t(raw).to(torch.int32)):  # int64 words, int32 patterns
        got = (ops.msxor_uniform if to_uniform else ops.msxor_fold)(coded, n_stages=5)
        np.testing.assert_array_equal(want.astype(got.numpy().dtype), got.numpy())
    if to_uniform:
        assert float(got[:150].min()) >= 0.5  # bit 31 set: u in [0.5, 1)
    else:
        assert int(got[:150].min()) >= 2**31


def test_block_m_is_ignored():
    raw = _t(_raw(3, 8, 999))
    want = ops.msxor_fold(raw)
    for block_m in (128, 512, 4096):
        assert torch.equal(ops.msxor_fold(raw, block_m=block_m), want)
        assert torch.equal(
            ops.msxor_uniform(raw, block_m=block_m), msxor_uniform_ref(raw, 3)
        )


@partitionable
def test_raw_random_words_and_fold_match_jax():
    """The Fig. 9 path at (8, 4096): the biased raw words and their fold."""
    for p in (0.40, 0.45):
        jraw = jbitcell.raw_random_words(jax.random.PRNGKey(1), p, (8, 4096), nbits=32)
        key = convert.key_from_numpy(jax.random.PRNGKey(1), device="cpu")
        raw = bitcell.raw_random_words(key, p, (8, 4096), nbits=32)
        np.testing.assert_array_equal(np.asarray(jraw).astype(np.int64), raw.numpy())
        np.testing.assert_array_equal(
            np.asarray(jops.msxor_fold(jraw)).astype(np.int64), ops.msxor_fold(raw).numpy()
        )


@pytest.mark.parametrize("n_stages", [0, 1, 3])
def test_plain_version_matches_jax_ref(n_stages):
    raw = _raw(n_stages, 1 << n_stages, 257)
    want = np.asarray(jfold_ref(jnp.asarray(raw), n_stages)).astype(np.int64)
    np.testing.assert_array_equal(want, msxor_fold_ref(_t(raw), n_stages).numpy())


def test_shape_errors():
    with pytest.raises(ValueError):
        msxor_fold_ref(torch.zeros(6, 4, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="G must be"):
        ops.msxor_fold(torch.zeros(4, 4, dtype=torch.int64), n_stages=3)
    with pytest.raises(ValueError, match="n_stages"):
        ops.msxor_fold(torch.zeros(64, 4, dtype=torch.int64), n_stages=6)
    with pytest.raises(ValueError, match="n_stages"):
        ops.msxor_fold(torch.zeros(1, 4, dtype=torch.int64), n_stages=0)
    with pytest.raises(ValueError, match="integer"):
        ops.msxor_fold(torch.zeros(8, 4), n_stages=3)
    with pytest.raises(ValueError, match="M must be"):
        ops.msxor_fold(torch.zeros(8, 0, dtype=torch.int64), n_stages=3)


def test_launch_count_stays_zero_on_cpu():
    kmsxor.reset_launches()
    ops.msxor_fold(_t(_raw(0, 8, 64)))
    ops.msxor_uniform(_t(_raw(0, 8, 64)))
    assert kmsxor.LAUNCHES == {"msxor": 0}
