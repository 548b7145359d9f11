"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports only torch and the port (no JAX), so it runs on a machine
that has the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from repro_torch import prng, samplers, workloads
from repro_torch.core import targets
from repro_torch.core.macro import CIMMacro, MacroConfig
from repro_torch.kernels import _build, rng
from repro_torch.kernels.gibbs import gibbs as gk
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import mh, ref
from repro_torch.kernels.msxor import msxor as kmsxor
from repro_torch.kernels.msxor import ops as msxor_ops
from repro_torch.kernels.msxor.ref import msxor_fold_ref, msxor_uniform_ref

pytestmark = pytest.mark.gpu

KAT = [  # Random123 Threefry-2x32-20 known-answer vectors: key, counter, out
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rs, shape, high):
    return torch.from_numpy(rs.integers(0, high, size=shape, dtype=np.uint64).astype(np.int64))


def test_device_cipher(cuda):
    for key, ctr, out in KAT:
        y0, y1 = rng.threefry2x32_device(*(torch.tensor([v], device=cuda) for v in (*key, *ctr)))
        assert (int(y0), int(y1)) == out
    rs = np.random.default_rng(0)
    args = [_words(rs, (4099,), 2**32) for _ in range(4)]
    d0, d1 = rng.threefry2x32_device(*(a.to(cuda) for a in args))
    h0, h1 = rng.threefry2x32(*args)
    assert torch.equal(d0.cpu(), h0) and torch.equal(d1.cpu(), h1)


@pytest.mark.parametrize("v", [300, 70_000])  # staged row / global gather
def test_kernels_match_plain(cuda, v):
    rs = np.random.default_rng(v)
    b, c, k, nbits = 3, 200, 16, 17
    table = torch.from_numpy((rs.normal(size=(b, v)) * 3).astype(np.float32)).to(cuda)
    init = _words(rs, (b, c), v).to(cuda)
    flips = _words(rs, (k, b, c), 2**nbits).to(cuda)
    u = torch.from_numpy((rs.integers(0, 2**16, size=(k, b, c)) / 2**16).astype(np.float32)).to(cuda)
    mh.reset_launches()
    s, a = mh.mh_chain(table, init, flips, u, nbits)
    rs_, ra = ref.mh_chain_ref(table, init, flips, u, nbits)
    assert torch.equal(s, rs_) and torch.equal(a, ra)
    cols = torch.arange(c, device=cuda)
    kw = dict(nbits=nbits, n_steps=k, cc=50, p_u32=rng.threshold_u32(0.45))
    t0c = cols * 11 + 2**32 - 5  # wraps mod 2^32 inside the chunk
    s, a = mh.mh_chain_fused(table, init, cols * 7, cols * 3 + 1, t0c, **kw)
    rs_, ra = ref.mh_chain_fused_ref(table, init, cols * 7, cols * 3 + 1, t0c, **kw)
    assert torch.equal(s, rs_) and torch.equal(a, ra)
    assert mh.LAUNCHES == {"mh_chain": 1, "mh_chain_fused": 1}


# (B, V, C, K, nbits, cc) the chain-tile kernel must get right; V as an
# offset from the longest staged row where it is a string
MH_SHAPES = {
    "C=1": (8, 49_155, 1, 40, 16, 1),
    "ragged C and K": (64, 301, 300, 37, 16, 300),
    "K=0": (4, 500, 100, 0, 8, 100),
    "K=1": (4, 500, 100, 1, 8, 100),
    "nbits 1": (3, 2, 70, 20, 1, 70),
    "nbits 18": (2, 70_001, 64, 12, 18, 64),
    "nbits 32": (2, 1001, 50, 20, 32, 25),
    "V at the staged limit": (3, "0", 40, 9, 16, 40),
    "V below the staged limit": (3, "-1", 40, 9, 16, 40),
    "V above the staged limit": (3, "+1", 40, 9, 16, 40),
    "odd V, odd b": (5, 1003, 33, 19, 10, 33),
    "cc < C": (3, 777, 96, 21, 16, 24),
    "B=1": (1, 256, 64, 32, 8, 64),
    "row ends": (5, 1003, 64, 30, 3, 64),
    "row ends at the staged limit": (4, "0", 64, 30, 3, 64),
}


def _row_ends(b, c, v):
    """(B, C) words at both ends of a row: the ragged head and tail of an
    unaligned row are the first and last words, and 3-bit flips keep a
    chain among them (or move it past V, to -inf)."""
    j = torch.arange(c) % 8
    return torch.where(torch.arange(c) % 2 == 0, j, v - 1 - j).expand(b, c).contiguous()


@pytest.mark.parametrize("case", list(MH_SHAPES))
def test_mh_kernels_hold_at_tile_shapes(cuda, case):
    """Both MH kernels against their plain versions at tolerance 0, with
    words past 2^31 and per-column step bases near 2^31 (wrapping)."""
    b, v, c, k, nbits, cc = MH_SHAPES[case]
    if isinstance(v, str):
        v = mh.staged_vocab(cuda.index) + int(v)
    rs = np.random.default_rng(sum(map(ord, case)))
    table = torch.from_numpy((rs.normal(size=(b, v)) * 3).astype(np.float32)).to(cuda)
    init = (_row_ends(b, c, v) if "row ends" in case else _words(rs, (b, c), v)).to(cuda)
    init[0, 0] = 2**32 - 1  # outside the table: -inf until a finite move
    flips = _words(rs, (k, b, c), 2**nbits).to(cuda)
    u = rs.integers(0, 2**16, size=(k, b, c)) / 2**16
    u = torch.from_numpy(u.astype(np.float32)).to(cuda)
    s, a = mh.mh_chain(table, init, flips, u, nbits)
    rs_, ra = ref.mh_chain_ref(table, init, flips, u, nbits)
    assert s.dtype == torch.int64 and tuple(s.shape) == (k, b, c)
    assert torch.equal(s, rs_) and torch.equal(a, ra)
    k0c, k1c = (_words(rs, (c,), 2**32).to(cuda) for _ in range(2))
    t0c = torch.from_numpy(2**31 - 5 + rs.integers(0, 9, size=c)).to(cuda)
    kw = dict(nbits=nbits, n_steps=k, cc=cc, p_u32=rng.threshold_u32(0.45))
    s, a = mh.mh_chain_fused(table, init, k0c, k1c, t0c, **kw)
    rs_, ra = ref.mh_chain_fused_ref(table, init, k0c, k1c, t0c, **kw)
    assert torch.equal(s, rs_) and torch.equal(a, ra)


def test_mh_chain_custom_op(cuda):
    """The operand launch is the operator ``repro_torch::mh_chain``: called
    through ``torch.ops`` on the card it equals ``mh_chain_ref`` and counts
    one launch; its fake implementation (a dry run's fake tensors on the
    card) gives samples (K, B, C) int64 and accept (B, C) int32 on the
    card and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rs = np.random.default_rng(11)
    b, v, c, k, nbits = 4, 32_001, 1, 32, 16
    table = torch.from_numpy((rs.normal(size=(b, v)) * 3).astype(np.float32)).to(cuda)
    init = _words(rs, (b, c), v).to(cuda)
    flips = _words(rs, (k, b, c), 2**nbits).to(cuda)
    u = torch.from_numpy((rs.integers(0, 2**16, size=(k, b, c)) / 2**16).astype(np.float32))
    u = u.to(cuda)
    mh.reset_launches()
    s, a = torch.ops.repro_torch.mh_chain(table, init, flips, u, nbits)
    rs_, ra = ref.mh_chain_ref(table, init, flips, u, nbits)
    assert torch.equal(s, rs_) and torch.equal(a, ra)
    assert mh.LAUNCHES == {"mh_chain": 1, "mh_chain_fused": 0}
    with FakeTensorMode() as fake:
        fs, fa = mh.mh_chain(*(fake.from_tensor(t) for t in (table, init, flips, u)), nbits)
    assert (tuple(fs.shape), fs.dtype, fs.device) == ((k, b, c), torch.int64, cuda)
    assert (tuple(fa.shape), fa.dtype, fa.device) == ((b, c), torch.int32, cuda)
    assert mh.LAUNCHES == {"mh_chain": 1, "mh_chain_fused": 0}


def test_launch_errors_raise(cuda):
    table = torch.zeros(70_000, 2, device=cuda).t()  # not contiguous
    init = torch.zeros(2, 4, dtype=torch.int64, device=cuda)
    flips = torch.zeros(3, 2, 4, dtype=torch.int64, device=cuda)
    u = torch.zeros(3, 2, 4, device=cuda)
    with pytest.raises(ValueError):
        mh.mh_chain(table, init, flips, u, 4)
    with pytest.raises(ValueError):
        mh.mh_chain(table.contiguous(), init.cpu(), flips, u, 4)


@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("num_chains", [1, 2])
def test_engine_card_equals_cpu(cuda, randomness, num_chains):
    rs = np.random.default_rng(5)
    table = (rs.normal(size=(3, 500)) * 2).astype(np.float32)
    init = rs.integers(0, 500, size=(num_chains, 3, 8)) if num_chains > 1 else rs.integers(0, 500, size=(3, 8))
    runs = {}
    for device in (cuda, "cpu"):
        eng = samplers.MHEngine(
            samplers.EngineConfig(randomness=randomness, num_chains=num_chains, chunk_steps=7),
            device=device,
        )
        runs[str(device)] = eng.submit(
            samplers.RunPlan(
                target=samplers.TableTarget(torch.from_numpy(table).to(device)),
                n_steps=30, init_words=init, seed=11, step0=3,
            )
        )
    a, b = runs.values()
    for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


def test_engine_defaults_to_the_card(cuda):
    eng = samplers.MHEngine()
    assert eng.device == cuda
    with pytest.raises(ValueError, match="engine's device"):
        eng.submit(
            samplers.RunPlan(
                target=samplers.TableTarget(torch.zeros(2, 5)), n_steps=2,
                init_words=np.zeros((2, 3)), seed=0,
            )
        )


def _lattice_logit(rs, h, w, spin_glass, device):
    if not spin_glass:
        return gref.IsingLogit(0.4407, 0.05)
    j = [torch.from_numpy(rs.choice([-1.0, 1.0], size=(h, w)).astype(np.float32)).to(device)
         for _ in range(2)]
    return gref.SpinGlassLogit(*j, field=0.1)


def _tie_uniforms(rs, init, logit, parity0, k):
    """(K, B, H, W) uniforms at every site's flip probability p of its
    half-sweep, or one ULP below or above it: each active site's flip is a
    tie, decided by the float compare u < p alone."""
    u = torch.empty((k, *init.shape), device=init.device)
    state = init
    for step in range(k):
        p = gref.sigmoid(logit(state))
        pick = torch.from_numpy(rs.integers(0, 3, size=tuple(init.shape))).to(init.device)
        u[step] = torch.where(pick == 0, p, torch.nextafter(p, 2 * pick - 3.0))
        state = gref.gibbs_chain_ref(state, u[step:step + 1], logit, parity0 + step)[0][0]
    return u


@pytest.mark.parametrize("h,w,spin_glass,uniforms", [
    (7, 9, False, "grid"), (8, 6, True, "grid"), (64, 96, False, "grid"),
    (7, 9, False, "off grid"), (8, 6, True, "off grid"),  # u any float32
    (7, 9, False, "p +- 1 ulp"), (8, 6, True, "p +- 1 ulp"),
    (64, 96, False, "two groups"),  # a forced multi-group launch
])
def test_gibbs_kernels_match_plain(cuda, h, w, spin_glass, uniforms):
    """Odd lattice, spin glass with couplings, per-lattice parity and t0
    that differ between lattices and wrap mod 2^32 inside the chunk.  The
    operand kernel tests u < p in floats: u on the 2^-24 grid (numpy's
    float32 draw), off it (float64 draws rounded to float32), or within
    one ULP of p at every site; one kernel launch per lattice group."""
    rs = np.random.default_rng(h * w)
    b, k = 3, 20
    init = torch.from_numpy(rs.integers(0, 2, size=(b, h, w))).to(cuda)
    logit = _lattice_logit(rs, h, w, spin_glass, cuda)
    parity0 = torch.tensor([0, 1, 1], device=cuda)
    if uniforms == "off grid":
        u = torch.from_numpy(rs.random(size=(k, b, h, w)).astype(np.float32)).to(cuda)
        assert bool((u * 2**24 != torch.floor(u * 2**24)).any())
    elif uniforms == "p +- 1 ulp":
        u = _tie_uniforms(rs, init, logit, parity0, k)
    else:
        u = torch.from_numpy(rs.random(size=(k, b, h, w), dtype=np.float32)).to(cuda)
    groups = gk.plan_groups(b, h, w, **gk.band_limits(cuda.index, w))
    gk.reset_launches()
    if uniforms == "two groups":
        groups = [gk.Group(0, 1, 8, 8), gk.Group(1, 2, 4, 16)]
        s, f = gk._launch_gibbs_chain(init.int(), u, logit, _build.to_u32_bits(parity0),
                                      groups=groups)
    else:
        s, f = gk.gibbs_chain(init, u, logit, parity0)
    rs_, rf = gref.gibbs_chain_ref(init, u, logit, parity0)
    assert torch.equal(s, rs_) and torch.equal(f, rf)
    assert gk.LAUNCHES["gibbs_chain"] == len(groups)
    lat = torch.arange(b, device=cuda)
    t0b = torch.tensor([3, 2**31 - 7, -4], device=cuda)
    kw = dict(n_steps=k, lat_b=2)
    s, f = gk.gibbs_chain_fused(init, lat * 7, lat * 3 + 1, t0b, logit, **kw)
    rs_, rf = gref.gibbs_chain_fused_ref(init, lat * 7, lat * 3 + 1, t0b, logit, **kw)
    assert torch.equal(s, rs_) and torch.equal(f, rf)
    assert gk.LAUNCHES["gibbs_chain_fused"] == len(gk.plan_groups(
        b, h, w, **gk.band_limits(cuda.index, w)))


def test_gibbs_launch_errors_raise(cuda):
    init = torch.zeros(2, 4, 4, dtype=torch.int64, device=cuda)
    u = torch.zeros(3, 2, 4, 4, device=cuda)
    parity0 = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="IsingLogit"):
        gk.gibbs_chain(init, u, object(), parity0)
    with pytest.raises(ValueError):
        gk.gibbs_chain(init, u.cpu(), gref.IsingLogit(0.3), parity0)
    # a band of more rows than a block holds (csrc/gibbs.cu:band_max_rows)
    # is refused at launch and raises
    init32 = torch.zeros(1, 2000, 8, dtype=torch.int32, device=cuda)
    u1 = torch.zeros(1, 1, 2000, 8, device=cuda)
    words = torch.zeros(1, dtype=torch.int32, device=cuda)
    rows = gk.band_limits(cuda.index, 8)["max_rows"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        gk._launch_gibbs_chain(init32, u1, gref.IsingLogit(0.3), words,
                               groups=[gk.Group(0, 1, 1, rows + 1)])
    # a lattice past the per-lattice limit (132 bands on the H100), as for
    # the fused entry point
    big = torch.zeros(1, 8192, 8192, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="too large for one cooperative launch"):
        gk.gibbs_chain(big, torch.zeros(1, 1, 8192, 8192, device=cuda), gref.IsingLogit(0.3),
                       words)
    assert _build.library() is not None


def _band_operands(rs, b, h, w, spin_glass, cuda):
    """init, key words, a per-lattice t0b of mixed parities (one wraps
    mod 2^32 inside the chunk) and a logit spec."""
    init = torch.from_numpy(rs.integers(0, 2, size=(b, h, w))).to(cuda)
    k0b, k1b = (_words(rs, (b,), 2**32).to(cuda) for _ in range(2))
    t0b = torch.tensor([3, -4, 2**31 - 7, 10] * (b // 4 + 1), device=cuda)[:b]
    return init, k0b, k1b, t0b, _lattice_logit(rs, h, w, spin_glass, cuda)


@pytest.mark.parametrize("b,h,w,k,spin_glass,lat_b", [
    (3, 5, 7, 24, False, 2),       # odd: neighbours across the wrap share a colour
    (2, 3, 5, 17, False, 1),
    (4, 64, 96, 1, False, 4),      # K = 1
    (3, 33, 40, 30, True, 3),      # spin glass, bands of several rows
    (2, 256, 256, 300, False, 2),  # past the flush of the uint8 flip counts
])
def test_band_kernel_matches_plain(cuda, b, h, w, k, spin_glass, lat_b):
    rs = np.random.default_rng([b, h, w, k])
    init, k0b, k1b, t0b, logit = _band_operands(rs, b, h, w, spin_glass, cuda)
    gk.reset_launches()
    s, f = gk._launch_gibbs_chain_fused(
        init.int(), _build.to_u32_bits(k0b), _build.to_u32_bits(k1b), _build.to_u32_bits(t0b),
        logit, n_steps=k, lat_b=lat_b,
    )
    rs_, rf = gref.gibbs_chain_fused_ref(init, k0b, k1b, t0b, logit, k, lat_b)
    assert s.dtype == rs_.dtype == torch.int32 and f.dtype == rf.dtype == torch.int32
    assert torch.equal(s, rs_) and torch.equal(f, rf)
    assert gk.LAUNCHES["gibbs_chain_fused"] == 1


def test_band_kernel_groups(cuda):
    """16 lattices of 1024 x 1024 under lat_b = 4 take more than one
    cooperative launch; each group keeps its lattices' site bases."""
    rs = np.random.default_rng(16)
    init, k0b, k1b, t0b, logit = _band_operands(rs, 16, 1024, 1024, False, cuda)
    groups = gk.plan_groups(16, 1024, 1024, **gk.band_limits(cuda.index, 1024))
    assert len(groups) > 1
    gk.reset_launches()
    s, f = gk.gibbs_chain_fused(init, k0b, k1b, t0b, logit, n_steps=4, lat_b=4)
    assert gk.LAUNCHES["gibbs_chain_fused"] == len(groups)
    rs_, rf = gref.gibbs_chain_fused_ref(init, k0b, k1b, t0b, logit, 4, 4)
    assert torch.equal(s, rs_) and torch.equal(f, rf)


def test_band_kernel_refusals_raise(cuda):
    init = torch.zeros(1, 2000, 8, dtype=torch.int32, device=cuda)
    words = torch.zeros(1, dtype=torch.int32, device=cuda)
    logit = gref.IsingLogit(0.3)
    # more blocks than the card holds at once: the cooperative launch is refused
    with pytest.raises(RuntimeError, match="failed to launch"):
        gk._launch_gibbs_chain_fused(init, words, words, words, logit, n_steps=2, lat_b=1,
                                     groups=[gk.Group(0, 1, 1000, 2)])
    # a band of more rows than a block holds (csrc/gibbs.cu:band_max_rows)
    rows = gk.band_limits(cuda.index, 8)["max_rows"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        gk._launch_gibbs_chain_fused(init, words, words, words, logit, n_steps=2, lat_b=1,
                                     groups=[gk.Group(0, 1, 1, rows + 1)])
    # a lattice past the per-lattice limit
    big = torch.zeros(1, 8192, 8192, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="too large for one cooperative launch"):
        gk.gibbs_chain_fused(big, words, words, words, logit, n_steps=2, lat_b=1)


@pytest.mark.parametrize("name", ["ising", "spin_glass"])
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("num_chains", [1, 2])
def test_gibbs_engine_card_equals_cpu(cuda, name, randomness, backend, num_chains):
    runs = {}
    shape = dict(height=6, width=8) if name == "spin_glass" else dict(height=7, width=9)
    for device in (cuda, "cpu"):
        wl = workloads.build(
            name, np.array([0, 5], np.uint32), randomness=randomness, backend=backend,
            batch=2, n_steps=23, chunk_steps=6, num_chains=num_chains, device=device,
            **shape,
        )
        runs[str(device)] = wl.engine.submit(wl.plan(np.array([0, 9]), step0=3)).result
    a, b = runs.values()
    for f in ("samples", "accept_count", "final_words", "acceptance_rate"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.allclose(a.final_logp.cpu(), b.final_logp, rtol=4 * 2**-23, atol=0)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("m", [1, 3, 777, 4096, 4099])
def test_msxor_kernel_matches_plain(cuda, n_stages, m):
    """Both outputs, word for word, on random bit patterns (bit 31 set in
    half the words), from int64 words and from their int32 patterns."""
    rs = np.random.default_rng([n_stages, m])
    raw = _words(rs, (1 << n_stages, m), 2**32).to(cuda)
    kmsxor.reset_launches()
    words = msxor_ops.msxor_fold(raw, n_stages=n_stages)
    u = msxor_ops.msxor_uniform(raw, n_stages=n_stages)
    assert kmsxor.LAUNCHES == {"msxor": 2}
    assert torch.equal(words, msxor_fold_ref(raw, n_stages))
    assert torch.equal(u, msxor_uniform_ref(raw, n_stages))
    coded = _build.to_u32_bits(raw)  # int32 patterns, negative ones included
    assert torch.equal(msxor_ops.msxor_fold(coded, n_stages=n_stages), words)
    assert words.device == cuda and u.dtype == torch.float32


def test_msxor_launch_errors_raise(cuda):
    with pytest.raises(ValueError):
        msxor_ops.msxor_fold(torch.zeros(8, 4, device=cuda))  # float words
    with pytest.raises(ValueError):
        msxor_ops.msxor_fold(torch.zeros(4, 4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="n_stages"):
        msxor_ops.msxor_fold(torch.zeros(1, 4, dtype=torch.int64, device=cuda), n_stages=0)


def test_fig9_draw_card_equals_cpu(cuda):
    from repro_torch.core import bitcell

    for p in (0.40, 0.45):
        a = bitcell.raw_random_words(prng.PRNGKey(1, device=cuda), p, (8, 4096))
        b = bitcell.raw_random_words(prng.PRNGKey(1), p, (8, 4096))
        assert torch.equal(a.cpu(), b)
        assert torch.equal(msxor_ops.msxor_fold(a).cpu(), msxor_ops.msxor_fold(b))


def test_macro_card_equals_cpu(cuda):
    """tests/test_core_sampling.py's macro run (nbits 8, burn-in 200, 2,000
    samples): its seed has no tie event within 4 ULP of each log-prob
    (tests/test_torch_paper_core.py), so the chains agree exactly."""
    gmm, codec = targets.GaussianMixture.paper_gmm(), targets.GridCodec(8, 1, (-10.0,), (10.0,))
    runs = [
        CIMMacro(MacroConfig(nbits=8, burn_in=200), device=d).sample_points(
            prng.PRNGKey(9), gmm, codec, n_samples=2000
        )
        for d in (cuda, "cpu")
    ]
    (pa, sa), (pb, sb) = runs
    np.testing.assert_array_equal(pa, pb)
    assert sa == sb


@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
def test_gmm_card_equals_cpu(cuda, randomness):
    runs = {}
    for device in (cuda, "cpu"):
        wl = workloads.build("gmm", np.array([0, 5], np.uint32), randomness=randomness,
                             backend="pallas", smoke=True, device=device)
        runs[str(device)] = wl.run(np.array([0, 4], np.uint32))
    a, b = runs.values()
    for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


# --- checkpoints, resume, telemetry and the chains mesh on the card --------


@pytest.mark.parametrize("update,randomness", [("mh", "cim"), ("mh", "fused"),
                                               ("gibbs", "fused"), ("gibbs", "host")])
def test_resume_on_the_card_equals_one_submit(cuda, tmp_path, update, randomness):
    """A run killed after its second segment and finished from its
    checkpoints equals one unsegmented submit on the card, and the CPU's
    resumable run of the same plan."""
    from repro_torch.checkpoint import run_resumable

    if update == "mh":
        rs = np.random.default_rng(3)
        table = torch.from_numpy((rs.normal(size=(4, 300)) * 3).astype(np.float32))
        init = rs.integers(0, 300, size=(4, 24)).astype(np.uint32)
        target = {d: samplers.TableTarget(table.to(d)) for d in (cuda, "cpu")}
    else:
        from repro_torch.workloads.ising import IsingModel

        init = np.random.default_rng(4).integers(0, 2, size=(2, 16, 16)).astype(np.uint32)
        target = {d: IsingModel(16, 16, beta=0.4407) for d in (cuda, "cpu")}
    results = {}
    for d in (cuda, "cpu"):
        eng = samplers.MHEngine(samplers.EngineConfig(
            update=update, randomness=randomness, execution="pallas", chunk_steps=8), device=d)
        plan = samplers.RunPlan(target=target[d], n_steps=40, init_words=init, seed=6,
                                collect="thin:4")

        def die(done, total, handle):
            if done == 20:
                raise RuntimeError("preempted")

        directory = str(tmp_path / str(d))
        with pytest.raises(RuntimeError, match="preempted"):
            run_resumable(eng, plan, directory=directory, every=10, on_segment=die)
        results[str(d)] = run_resumable(eng, plan, directory=directory, every=10).result
        if d == cuda:
            one = eng.submit(plan).result
            for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
                assert torch.equal(getattr(results[str(d)], f), getattr(one, f)), f
    a, b = results.values()
    for f in ("samples", "accept_count", "final_words", "acceptance_rate"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


def test_handle_save_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, load_checkpoint_tree

    rs = np.random.default_rng(5)
    table = torch.from_numpy(rs.normal(size=(2, 100)).astype(np.float32)).to(cuda)
    eng = samplers.MHEngine(samplers.EngineConfig(randomness="fused"))
    handle = eng.submit(samplers.RunPlan(target=samplers.TableTarget(table), n_steps=16,
                                         init_words=np.zeros((2, 32), np.uint32), seed=2))
    handle.save(str(tmp_path))
    tree, manifest = load_checkpoint_tree(str(tmp_path), 16)
    assert [e["dtype"] for e in manifest["leaves"]] == ["int32", "float32", "uint32"]
    assert np.array_equal(tree["words"], handle.final_words.cpu().numpy())
    like = {"acc": handle.accept_count, "logp": handle.final_logp, "words": handle.final_words}
    back, _ = load_checkpoint(str(tmp_path), 16, like, device=cuda)
    for k, v in like.items():
        assert back[k].device == v.device and back[k].dtype == v.dtype and torch.equal(back[k], v)


def test_telemetry_keeps_the_stream_on_the_card(cuda):
    from repro_torch import telemetry

    rs = np.random.default_rng(6)
    table = torch.from_numpy(rs.normal(size=(4, 500)).astype(np.float32)).to(cuda)
    eng = samplers.MHEngine(samplers.EngineConfig(randomness="fused"))
    plan = samplers.RunPlan(target=samplers.TableTarget(table), n_steps=128,
                            init_words=np.zeros((4, 64), np.uint32), seed=3)
    off = eng.submit(plan).result
    tr = telemetry.enable()
    try:
        on = eng.submit(plan).result
    finally:
        telemetry.disable()
    assert len([e for e in tr.events() if e.name == "engine.submit"]) == 1
    assert torch.equal(off.samples, on.samples) and torch.equal(off.final_words, on.final_words)


@pytest.mark.parametrize("update", ["mh", "gibbs"])
def test_one_rank_nccl_mesh(cuda, update):
    """A one-rank ``nccl`` DeviceMesh on the card shards the chains axis
    (every chain on rank 0, gathered by NCCL): equal to the unsharded run;
    ``make_chains_mesh`` gives None on one card."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as tmesh

    assert tmesh.make_chains_mesh() is None
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=cuda)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        if update == "mh":
            rs = np.random.default_rng(7)
            target = samplers.TableTarget(
                torch.from_numpy(rs.normal(size=(4, 300)).astype(np.float32)).to(cuda))
            init = rs.integers(0, 300, size=(4, 4, 40)).astype(np.uint32)
        else:
            from repro_torch.workloads.ising import IsingModel

            target = IsingModel(16, 16)
            init = np.random.default_rng(8).integers(0, 2, size=(4, 2, 16, 16)).astype(np.uint32)
        eng = samplers.MHEngine(samplers.EngineConfig(update=update, randomness="fused",
                                                      execution="pallas", num_chains=4))
        plan = samplers.RunPlan(target=target, n_steps=32, init_words=init, seed=4)
        a = eng.submit(plan).result
        b = eng.submit(plan.replace(mesh=mesh)).result
        for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    finally:
        dist.destroy_process_group()


# --- the compiled entry: submit(compiled=True) as a CUDA graph ------------------

RESULT_FIELDS = ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate")


def _compiled_case(cuda, path):
    """(engine, plan, plan on another key and init) for one path of the
    compiled entry, at sizes that take milliseconds."""
    rs = np.random.default_rng(21)
    if path.startswith("gibbs"):
        _, randomness, backend = path.split("_")
        wl = workloads.build("ising", prng.PRNGKey(3, device=cuda), randomness=randomness,
                             backend=backend, height=32, width=32, batch=2, n_steps=40,
                             chunk_steps=16, collect="thin:3")
        plan = wl.plan(prng.PRNGKey(4, device=cuda))
        other = torch.from_numpy(rs.integers(0, 2, size=(2, 32, 32))).to(cuda)
        return wl.engine, plan, plan.replace(key=prng.PRNGKey(5, device=cuda), init_words=other)
    randomness, execution, chains = path.split("_")
    chains = int(chains[-1])
    table = torch.from_numpy((rs.normal(size=(4, 700)) * 2).astype(np.float32)).to(cuda)
    target = samplers.TableTarget(table)
    lead = (chains,) if chains > 1 else ()
    init, other = (torch.from_numpy(rs.integers(0, 700, size=(*lead, 4, 64))).to(cuda)
                   for _ in range(2))
    eng = samplers.MHEngine(samplers.EngineConfig(randomness=randomness, execution=execution,
                                                  num_chains=chains, chunk_steps=16))
    plan = samplers.RunPlan(target=target, n_steps=50, init_words=init, seed=8, step0=5,
                            collect="thin:4")
    if execution == "scan" and chains == 1:
        plan = plan.replace(init_logp=target.log_prob(init))
        return eng, plan, plan.replace(seed=9, init_words=other,
                                       init_logp=target.log_prob(other))
    return eng, plan, plan.replace(seed=9, init_words=other)


COMPILED_PATHS = ["host_pallas_c1", "cim_pallas_c1", "fused_pallas_c1", "cim_scan_c1",
                  "fused_scan_c1", "fused_pallas_c2", "cim_pallas_c2", "gibbs_fused_pallas",
                  "gibbs_cim_pallas", "gibbs_fused_scan"]


def _launches():
    return {**mh.LAUNCHES, **gk.LAUNCHES}


@pytest.mark.parametrize("path", COMPILED_PATHS)
def test_compiled_replay_equals_direct(cuda, path):
    """A replay equals the direct path bit for bit, and the kernels'
    launch counters grow by the same counts on both paths."""
    eng, plan, _ = _compiled_case(cuda, path)
    mh.reset_launches()
    gk.reset_launches()
    direct = eng.submit(plan).result
    counts = _launches()
    for _ in range(3):  # the capture, then two replays
        mh.reset_launches()
        gk.reset_launches()
        got = eng.submit(plan, compiled=True).result
        torch.cuda.synchronize()
        assert _launches() == counts
        for f in RESULT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(direct, f)), f
    (program,) = eng._compiled.values()
    assert program.graph is not None and program.nbytes > 0


@pytest.mark.parametrize("path", ["cim_pallas_c1", "fused_pallas_c2", "gibbs_fused_pallas"])
def test_compiled_result_survives_later_replays(cuda, path):
    """Submit 1's result is the caller's own: a later replay on other
    inputs (another key and init, the same signature) changes nothing in
    it, and that replay equals its own direct run."""
    eng, plan, other = _compiled_case(cuda, path)
    first = eng.submit(plan, compiled=True).result  # the capture
    second = eng.submit(plan, compiled=True).result  # a replay
    kept = [{f: getattr(r, f).clone() for f in RESULT_FIELDS} for r in (first, second)]
    third = eng.submit(other, compiled=True).result
    torch.cuda.synchronize()
    assert len(eng._compiled) == 1
    for k, r in zip(kept, (first, second)):
        for f in RESULT_FIELDS:
            assert torch.equal(k[f], getattr(r, f)), f
    assert not torch.equal(third.final_words, first.final_words)
    want = eng.submit(other).result
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(third, f), getattr(want, f)), f


def test_dropped_engine_frees_its_graphs(cuda):
    """The programs live on their engine: once it (and every handle that
    holds it) is dropped, its graphs and their pools are gone."""
    import gc
    import weakref

    eng, plan, _ = _compiled_case(cuda, "cim_pallas_c1")
    eng.submit(plan)  # builds the kernels first
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()  # also ends frees that wait on stream events
    before = torch.cuda.memory_allocated(cuda)
    handles = [eng.submit(plan, compiled=True) for _ in range(2)]
    (program,) = eng._compiled.values()
    graph = weakref.ref(program.graph)
    assert torch.cuda.memory_allocated(cuda) > before
    del eng, handles, program
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert graph() is None
    assert torch.cuda.memory_allocated(cuda) == before


def test_compiled_submit_on_one_rank_nccl_mesh(cuda):
    """The chains axis sharded over a one-rank ``nccl`` mesh: the
    all-gather is captured with the chunk loop, and replays equal the
    unsharded direct run."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=cuda)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        eng, plan, _ = _compiled_case(cuda, "fused_pallas_c2")
        direct = eng.submit(plan).result
        for _ in range(3):
            got = eng.submit(plan.replace(mesh=mesh), compiled=True).result
            for f in RESULT_FIELDS:
                assert torch.equal(getattr(got, f), getattr(direct, f)), f
        assert len(eng._compiled) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spin_glass", [False, True])
@pytest.mark.parametrize("scale", [0.37, 2.5])
def test_scaled_gibbs_kernels_match_plain(cuda, spin_glass, scale):
    """A tempered replica's spec (``scale`` != 1) through both draws:
    the scale is multiplied in last (the Ising flip table is built from
    the scaled logit), equal to the plain versions word for word."""
    import dataclasses

    rs = np.random.default_rng(int(scale * 100) + spin_glass)
    b, h, w, k = 3, 9, 12, 20
    init = torch.from_numpy(rs.integers(0, 2, size=(b, h, w))).to(cuda)
    logit = dataclasses.replace(_lattice_logit(rs, h, w, spin_glass, cuda), scale=scale)
    assert logit.scale == float(np.float32(scale))
    u = torch.from_numpy(rs.random(size=(k, b, h, w)).astype(np.float32)).to(cuda)
    parity0 = torch.tensor([0, 1, 1], device=cuda)
    s, f = gk.gibbs_chain(init, u, logit, parity0)
    rs_, rf = gref.gibbs_chain_ref(init, u, logit, parity0)
    assert torch.equal(s, rs_) and torch.equal(f, rf)
    lat = torch.arange(b, device=cuda)
    t0b = torch.tensor([3, 2**31 - 7, -4], device=cuda)
    kw = dict(n_steps=k, lat_b=b)
    s, f = gk.gibbs_chain_fused(init, lat * 5, lat + 9, t0b, logit, **kw)
    rs_, rf = gref.gibbs_chain_fused_ref(init, lat * 5, lat + 9, t0b, logit, **kw)
    assert torch.equal(s, rs_) and torch.equal(f, rf)


@pytest.mark.parametrize("update,randomness", [("mh", "fused"), ("mh", "cim"),
                                               ("gibbs", "fused"), ("gibbs", "host")])
def test_tempering_card_equals_cpu(cuda, update, randomness):
    """A replica exchange and an anneal through the kernels on the card
    equal the same runs on the CPU (the plain versions), with no tie
    event in the CPU run's draws or swaps."""
    from repro_torch import tempering
    from repro_torch.workloads.spin_glass import SpinGlass

    runs = {}
    for device in ("cpu", cuda):
        if update == "mh":
            rs = np.random.default_rng(3)
            target = samplers.TableTarget(
                torch.from_numpy(rs.normal(size=(2, 64)).astype(np.float32)).to(device))
            init = rs.integers(0, 64, size=(2, 8)).astype(np.uint32)
        else:
            target = SpinGlass.bimodal(prng.PRNGKey(1, device=device), 8, 8)
            init = target.random_init(prng.PRNGKey(2, device=device), 2).cpu().numpy()
        eng = samplers.MHEngine(samplers.EngineConfig(
            update=update, randomness=randomness, execution="pallas", chunk_steps=8),
            device=device)
        rex = tempering.ReplicaExchange(tempering.Ladder.geometric(3, 0.5), eng, swap_every=6)
        inits = np.broadcast_to(init, (3, *init.shape))
        if device == "cpu":
            assert rex.tie_events(prng.PRNGKey(7), target, 20, inits) == {"moves": 0, "swaps": 0}
        ann = tempering.Annealer.geometric(3, 6, 0.5, 2.0)
        runs[str(device)] = (rex.run(prng.PRNGKey(7), target, 20, inits),
                             ann.run(prng.PRNGKey(7), target, init, engine=eng))
    (rc, ac), (rg, ag) = runs["cpu"], runs[str(cuda)]
    for f in ("samples", "accept_count", "final_words", "final_logp"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    assert rg.swap.summary() == rc.swap.summary()
    for f in ("best_words", "best_logp", "final_words", "accept_count"):
        assert torch.equal(getattr(ag, f).cpu(), getattr(ac, f)), f


@pytest.mark.parametrize("workload,randomness", [("gmm", "fused"), ("gmm", "host"),
                                                 ("ising", "fused"), ("ising", "cim")])
def test_packed_chunk_is_one_launch(cuda, workload, randomness):
    """A packed pallas chunk is one kernel launch for all slots, and each
    served request equals its solo run on the card."""
    from repro_torch import serving

    ex = serving.PackedExecutor.for_workload(workload, n_slots=3, randomness=randomness,
                                             execution="pallas", smoke=True, chunk_steps=8)
    reqs = [serving.ServeRequest(rid=i, workload=workload, n_steps=16 + 8 * i, seed=i,
                                 collect=("all", "thin:3", "last")[i]) for i in range(3)]
    ex.admit(reqs[0])
    ex.advance_chunk()
    for r in reqs[1:]:
        ex.admit(r)
    mh.reset_launches()
    gk.reset_launches()
    chunks = 0
    while ex.active_count:
        before = sum(mh.LAUNCHES.values()) + sum(gk.LAUNCHES.values())
        ex.advance_chunk()
        chunks += 1
        assert sum(mh.LAUNCHES.values()) + sum(gk.LAUNCHES.values()) == before + 1
    ex.drain()
    assert chunks > 0
    for r in reqs:
        _assert_served_equals_solo(r, workload, randomness, cuda)


def _assert_served_equals_solo(r, workload, randomness, cuda):
    k_init, k_run = prng.split(prng.PRNGKey(r.seed, device=cuda))
    wl = workloads.build(workload, k_init, randomness=randomness, backend="pallas", smoke=True)
    ref_ = wl.engine.run(k_run, wl.target, r.n_steps, wl.init_words, collect=r.collect)
    assert np.array_equal(r.samples, ref_.samples.cpu().numpy())
    assert np.array_equal(r.final_words, ref_.final_words.cpu().numpy())
    assert np.array_equal(r.accept_count, ref_.accept_count.cpu().numpy())
    assert np.array_equal(r.final_logp, ref_.final_logp.cpu().numpy())


# the kernel advance's bursts: (chunk steps, the (rid, seed, steps, collect)
# admitted before each chunk): a mid-flight join, then a third request in
# the slot the second retires from
ADVANCE_PLANS = {
    "gmm": (8, [[(0, 1, 48, "all")], [(1, 2, 16, "thin:3")], [], [], [(2, 3, 32, "last")]]),
    "ising": (4, [[(0, 5, 32, "all")], [(1, 6, 16, "thin:3")], [], [], [], [],
                  [(2, 7, 32, "last")]]),
}


def _serve_advance_plan(workload, randomness, eager=False, record=None):
    """``ADVANCE_PLANS[workload]`` through a kernel executor on the card,
    its finalize deferred to the drain; with ``eager`` through the
    advance's body alone; ``record`` gets each call's handed-out
    ``(samples, accept)`` beside clones taken at once.  Returns (the
    requests, the advance's programs)."""
    from repro_torch import serving

    chunk, plan = ADVANCE_PLANS[workload]
    ex = serving.PackedExecutor.for_workload(workload, n_slots=2, randomness=randomness,
                                             execution="pallas", smoke=True, chunk_steps=chunk,
                                             pipeline_depth=16)
    programs = ex._advance.programs
    real = ex._advance.eager if eager else ex._advance

    def advance(*args, **kw):
        out = real(*args, **kw)
        if record is not None:
            record.append(((out[0], out[2]), (out[0].clone(), out[2].clone())))
        return out

    ex._advance = advance
    reqs = []
    for admits in plan:
        for rid, seed, n, collect in admits:
            reqs.append(serving.ServeRequest(rid=rid, workload=workload, n_steps=n, seed=seed,
                                             collect=collect))
            ex.admit(reqs[-1])
        ex.advance_chunk()
    while ex.active_count:
        ex.advance_chunk()
    ex.drain()
    return reqs, programs


@pytest.mark.parametrize("workload", ["gmm", "ising"])
@pytest.mark.parametrize("randomness", ["fused", "cim"])
def test_compiled_advance_equals_eager_body(cuda, workload, randomness):
    """Each chunk of the kernel advance is a replay of its (seg, collect)
    program, captured at other step bases; over a burst with a mid-flight
    join and a reused slot every request equals, at tolerance 0, its twin
    served through the advance's eager body and its solo run."""
    reqs, programs = _serve_advance_plan(workload, randomness)
    twins, unused = _serve_advance_plan(workload, randomness, eager=True)
    assert programs and all(p.graph is not None for p in programs.values()) and not unused
    for r, t in zip(reqs, twins):
        for f in ("samples", "final_words", "accept_count", "final_logp"):
            assert np.array_equal(getattr(r, f), getattr(t, f)), (r.rid, f)
        _assert_served_equals_solo(r, workload, randomness, cuda)


@pytest.mark.parametrize("workload", ["gmm", "ising"])
def test_compiled_advance_results_survive_replays(cuda, workload):
    """The samples and accept counts a replay hands out are its own
    tensors, and the retirement payloads are copied behind their segment:
    later replays, which overwrite the carry, change none of them."""
    record = []
    reqs, programs = _serve_advance_plan(workload, "fused", record=record)
    torch.cuda.synchronize()
    assert len(record) > len(programs)
    for handed, clones in record:
        assert all(map(torch.equal, handed, clones))
    for r in reqs:
        _assert_served_equals_solo(r, workload, "fused", cuda)


def _serve_scan_class(randomness, eager=False):
    """A gmm + ising scan class on 4 slots at smoke size: two requests from
    the first chunk, a third joining mid-flight; with ``eager`` through
    the advance's eager body.  Returns (the requests, the programs)."""
    from repro_torch import serving

    sched = serving.Scheduler(n_slots=4, randomness=randomness, execution="scan", smoke=True,
                              chunk_steps=8)
    ex = sched.executor_for("gmm")
    assert sched.executor_for("ising") is ex
    programs = ex._advance.programs
    if eager:
        ex._advance = ex._advance.eager
    reqs = [serving.ServeRequest(rid=0, workload="gmm", n_steps=40, seed=1, collect="all"),
            serving.ServeRequest(rid=1, workload="ising", n_steps=16, seed=2, collect="all")]
    for r in reqs:
        ex.admit(r)
    ex.advance_chunk()
    reqs.append(serving.ServeRequest(rid=2, workload="ising", n_steps=24, seed=3,
                                     collect="thin:3"))
    ex.admit(reqs[-1])
    while ex.active_count:
        ex.advance_chunk()
    ex.drain()
    return reqs, programs


@pytest.mark.parametrize("randomness", ["fused", "cim"])
def test_scan_class_advance_equals_eager_body(cuda, randomness):
    """Each chunk of a scan class is a replay of its (seg, collect)
    program, cut into a graph for every slot's every member (a section)
    and the graphs between sections, of which a chunk replays each
    occupied slot's own member's at its step base held on the card; with
    a mid-flight join every request equals, at tolerance 0, its twin
    served through the eager body and its solo scan run."""
    reqs, programs = _serve_scan_class(randomness)
    twins, unused = _serve_scan_class(randomness, eager=True)
    assert programs and all(p.graph is not None for p in programs.values())
    for p in programs.values():
        assert set(p.sections) == {(s, m) for s in range(4) for m in (0, 1)}
        keys = [k for k, _, _ in p.graph.pieces]
        assert keys.count(None) <= 2 and len(keys) == len(set(keys) - {None}) + keys.count(None)
    assert not unused
    for r, t in zip(reqs, twins):
        k_init, k_run = prng.split(prng.PRNGKey(r.seed, device=cuda))
        wl = workloads.build(r.workload, k_init, randomness=randomness, backend="scan",
                             smoke=True)
        solo = wl.engine.run(k_run, wl.target, r.n_steps, wl.init_words, collect=r.collect)
        for f in ("samples", "final_words", "accept_count", "final_logp"):
            assert np.array_equal(getattr(r, f), getattr(t, f)), (r.rid, f)
            assert np.array_equal(getattr(r, f), getattr(solo, f).cpu().numpy()), (r.rid, f)


@pytest.mark.parametrize("kind", ["ising", "table"])
def test_tempering_scan_segments_equal_direct_submits(cuda, kind, monkeypatch):
    """Tempering under scan replays one program a replica and segment
    length, its step0 staged; the run equals, at tolerance 0, the same
    run with every segment submitted directly at its int step0."""
    from repro_torch import tempering
    from repro_torch.tempering import exchange

    if kind == "ising":
        wl = workloads.build("ising", prng.PRNGKey(4, device=cuda), randomness="fused",
                             backend="scan", height=16, width=16, collect="all",
                             chunk_steps=5)
        eng, target, init = wl.engine, wl.target, wl.init_words
    else:
        gen = torch.Generator(device=cuda).manual_seed(5)
        target = samplers.TableTarget(torch.randn((4, 300), generator=gen, device=cuda))
        init = torch.argmax(target.table, -1)[:, None].expand(4, 8).contiguous()
        eng = samplers.MHEngine(samplers.EngineConfig(randomness="cim", execution="scan",
                                                      chunk_steps=5))
    ladder = tempering.Ladder.geometric(3, 0.3, 1.0)
    rex = tempering.ReplicaExchange(ladder, eng, swap_every=6)
    inits = init.expand(3, *init.shape)
    key = prng.PRNGKey(9, device=cuda)
    got = [rex.run(key, target, 16, inits) for _ in range(2)]  # captures, then replays
    programs = rex._programs
    assert len(programs) == 3 * 2  # segments of 6 and 4 steps
    assert all(p.graph is not None for p in programs.values())
    pools = {p.graph.pool() for p in programs.values()}
    assert len(pools) == 1  # one run replays them one at a time
    monkeypatch.setattr(exchange, "_scan_segment",
                        lambda programs, *args: exchange._segment_body(*args))
    want = rex.run(key, target, 16, inits)
    for res in got:
        for f in ("samples", "accept_count", "final_words", "final_logp"):
            assert torch.equal(getattr(res, f), getattr(want, f)), f
        assert res.swap.summary() == want.swap.summary()


def test_tempering_scan_segments_free_their_memory(cuda):
    """An exchange keeps the segment programs of its last run's targets
    only: runs on new base targets (new ladders of scaled targets) on one
    engine and exchange leave the card's memory where the first left it."""
    import gc

    from repro_torch import tempering
    from repro_torch.tempering import ladder as ladder_mod

    eng = samplers.MHEngine(samplers.EngineConfig(update="gibbs", randomness="fused",
                                                  execution="scan", chunk_steps=8))
    ladder = tempering.Ladder.geometric(3, 0.3, 1.0)
    rex = tempering.ReplicaExchange(ladder, eng, swap_every=8)
    held = []
    for seed in range(4):
        wl = workloads.build("ising", prng.PRNGKey(20 + seed, device=cuda), randomness="fused",
                             backend="scan", height=32, width=32, collect="all")
        res = rex.run(prng.PRNGKey(seed, device=cuda), wl.target, 16,
                      wl.init_words.expand(3, *wl.init_words.shape))
        assert bool(torch.isfinite(res.final_logp).all())
        del wl, res
        ladder_mod._cached_targets.cache_clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append((torch.cuda.memory_allocated(cuda), torch.cuda.memory_reserved(cuda)))
    assert held[1:] == held[:1] * 3, held


@pytest.mark.parametrize("update", ["mh", "gibbs"])
def test_tensor_step0_scan_submit_needs_no_host_sync(cuda, update):
    """A scan submit at a 0-d step0 tensor on the card neither reads it nor
    copies to the card from the host: it runs under the sync debug mode
    "error", and equals the int step0's run."""
    if update == "gibbs":
        wl = workloads.build("spin_glass", prng.PRNGKey(6, device=cuda), randomness="cim",
                             backend="scan", height=12, width=10, chunk_steps=4)
    else:
        wl = workloads.build("gmm", prng.PRNGKey(6, device=cuda), randomness="host",
                             backend="scan", smoke=True, chunk_steps=4)
    plan = samplers.RunPlan(target=wl.target, n_steps=11, init_words=wl.init_words,
                            key=prng.PRNGKey(7, device=cuda), step0=7)
    step0 = torch.full((), 7, dtype=torch.int64, device=cuda)
    wl.engine.submit(plan.replace(step0=step0))  # builds any cached table first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wl.engine.submit(plan.replace(step0=step0)).result
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = wl.engine.submit(plan).result
    for f in ("samples", "accept_count", "final_words", "final_logp"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# --- the autotuner and the CLIs on the card ------------------------------------------


def test_autotune_on_the_card(cuda, tmp_path):
    """The tuner on the card: the incumbent first, the winner at least as
    fast as it under the tuner's own clock (each run ended by a
    synchronise), a cache hit after, and the tuned stream unchanged."""
    rs = np.random.default_rng(5)
    table = torch.from_numpy((rs.normal(size=(8, 4096)) * 2).astype(np.float32)).to(cuda)
    target = samplers.TableTarget(table)
    init = torch.from_numpy(rs.integers(0, 4096, size=(8, 256))).to(cuda)
    cfg = samplers.EngineConfig(randomness="fused", chunk_steps=64)
    kw = dict(n_steps=64, repeats=2, chunk_candidates=(16, 256),
              cache_path=str(tmp_path / "tune.json"))
    tuned, res = samplers.autotune_config(cfg, target, init, **kw)
    assert res.source == "measured"
    assert res.candidates[0][:3] == (64, cfg.block_c, "pallas")  # auto on a card
    assert {c[2] for c in res.candidates} == {"scan", "pallas"}
    assert res.steps_per_s >= res.baseline_steps_per_s
    assert samplers.autotune_config(cfg, target, init, **kw)[1].source == "cache"
    plan = samplers.RunPlan(target=target, n_steps=200, init_words=init, seed=3)
    a = samplers.MHEngine(cfg).submit(plan).result
    b = samplers.MHEngine(tuned).submit(plan).result
    for f in ("samples", "accept_count", "final_words", "final_logp"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_clis_default_to_the_card(cuda, capsys):
    """``sample`` and ``serve_engine`` run on the card by default and give
    the CPU's rows (the kernels equal their plain versions)."""
    from repro_torch.launch import sample, serve_engine

    argv = ["--workload", "ising", "--height", "64", "--width", "64", "--batch", "2",
            "--randomness", "fused", "--backend", "pallas", "--steps", "64", "--thin", "4"]
    gk.reset_launches()
    card = sample.main(argv)
    assert gk.LAUNCHES["gibbs_chain_fused"] > 0
    cpu = sample.main(argv + ["--device", "cpu"])
    drop = ("wall_s", "site_steps_per_s")
    assert {k: v for k, v in card.items() if k not in drop} == {
        k: v for k, v in cpu.items() if k not in drop}
    capsys.readouterr()
    serve = ["--smoke", "--workload", "gmm,ising", "--requests", "4", "--slots", "2",
             "--randomness", "fused", "--backend", "pallas", "--collect", "all"]
    mh.reset_launches()
    row = serve_engine.main(serve)
    on_card = capsys.readouterr().out
    assert row["n_requests"] == 4 and mh.LAUNCHES["mh_chain_fused"] > 0
    serve_engine.main(serve + ["--device", "cpu"])
    rate = re.compile(r"req (\d+): workload=(\w+) .* (acceptance_rate|flip_rate)=(\S+)")
    assert rate.findall(on_card) == rate.findall(capsys.readouterr().out)


# --- the LLM server (slice 10) -------------------------------------------------------


def _smoke_servers(cuda, sampler, n_slots, max_len, gen, arch="granite3_8b"):
    """An architecture's smoke server on the CPU and on the card, with the
    CPU server's weights copied to the card."""
    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = configs.get_smoke_config(arch)
    scfg = serve.ServeConfig(n_slots=n_slots, max_len=max_len, gen_tokens=gen, sampler=sampler,
                             mcmc_steps=16, seed=0)
    host = serve.BatchedServer(cfg, scfg, device="cpu")
    card = serve.BatchedServer(cfg, scfg, device=cuda)
    card.model.load_state_dict(host.model.state_dict())
    return cfg, host, card


def _serve_all(server, prompts):
    from repro_torch.launch import serve

    queue, done = [serve.Request(rid=i, prompt=p) for i, p in enumerate(prompts)], []
    while queue or server.active():
        while queue and server.free_slot() is not None:
            server.submit(server.free_slot(), queue.pop(0))
        done.extend(server.step())
    return {r.rid: r.out_tokens for r in done}


class _Recorded:
    """Keeps each ``_sample`` call's logits (on the host) and key."""

    def __init__(self, server):
        self.calls, real = [], server._sample

        def sample(logits):
            self.calls.append((logits.float().cpu(), server.key.cpu()))
            return real(logits)

        server._sample = sample


def _server_card_equals_cpu(cuda, sampler, arch="granite3_8b", prompt_seed=3):
    """5 requests on 4 slots past ``main``'s cache sizing (the idle slots'
    writes clamp on the card without a device assert), with one
    ``mh_chain`` launch a sample under ``mcmc``.  Each sample is held
    under the tie rule: its greedy top-two gap, or its chain's accept
    margin over two, exceeds the card/CPU logit difference."""
    from repro_torch.samplers import chain_key

    gen = 12
    cfg, host, card = _smoke_servers(cuda, sampler, 4, 4 + 2 + gen + 8, gen, arch)
    rec_h, rec_c = _Recorded(host), _Recorded(card)
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=4 + i % 3) for i in range(5)]
    ref_streams = _serve_all(host, prompts)
    mh.reset_launches()
    out = _serve_all(card, prompts)
    torch.cuda.synchronize()
    v = cfg.vocab_size
    diff = max(float((a[0][:, :v] - b[0][:, :v]).abs().max())
               for a, b in zip(rec_h.calls, rec_c.calls))
    eng = samplers.MHEngine(host.sampler_cfg.engine_config(), device="cpu")
    for logits, key in rec_h.calls:
        table = logits[:, :v].contiguous()
        top = torch.topk(table, 2).values
        assert float((top[:, 0] - top[:, 1]).min()) > diff, "a near tie: replace the seed"
        if sampler == "mcmc":
            init = torch.argmax(table, dim=-1)[:, None]
            flips, u = eng.randomness.chunk(chain_key(prng.split(key)[1], 0), 0,
                                            host.sampler_cfg.n_steps, tuple(init.shape),
                                            host.sampler_cfg.nbits)
            margin = ref.accept_margin(table, init, flips, u, host.sampler_cfg.nbits)
            assert margin > 2 * diff, "a near tie: replace the seed"
    assert out == ref_streams
    assert int(card.cache["index"].max()) > card.scfg.max_len  # the clamped writes ran
    assert torch.equal(card.cache["index"].cpu(), host.cache["index"])
    want = 5 + 2 * gen if sampler == "mcmc" else 0
    assert mh.LAUNCHES == {"mh_chain": want, "mh_chain_fused": 0}
    if sampler == "mcmc":
        assert card.acceptance == host.acceptance


@pytest.mark.parametrize("sampler", ["greedy", "mcmc"])
def test_smoke_server_card_equals_cpu(cuda, sampler):
    _server_card_equals_cpu(cuda, sampler)


@pytest.mark.parametrize("sampler", ["greedy", "mcmc"])
@pytest.mark.parametrize("arch", ["hymba_1p5b", "mamba2_1p3b", "qwen3_moe_30b",
                                  "phi3_vision_4p2b", "whisper_large_v3"])
def test_family_server_card_equals_cpu(cuda, arch, sampler):
    """The MoE, SSM, hybrid, VLM and audio smoke servers (the prompts of
    tests/test_torch_serve.py's family cases)."""
    seed = 5 if arch in ("phi3_vision_4p2b", "whisper_large_v3") else 4
    _server_card_equals_cpu(cuda, sampler, arch, prompt_seed=seed)


def test_clamped_cache_write_on_the_card(cuda):
    from repro_torch.models import attention as attn

    buf = torch.zeros((4, 6, 2, 8), device=cuda)
    upd = torch.randn((4, 1, 2, 8), device=cuda)
    start = torch.tensor([0, 5, 6, 40], dtype=torch.int32, device=cuda)
    attn.update_rows(buf, upd, start)
    torch.cuda.synchronize()
    for row, pos in enumerate((0, 5, 5, 5)):
        assert torch.equal(buf[row, pos], upd[row, 0])
        assert int((buf[row] != 0).any(dim=(-1, -2)).sum()) == 1


def test_float32_products_on_the_card(cuda):
    """``matmul_f32`` on bfloat16 operands (the head's product on the
    card) against the widened float32 product: the same sums in another
    order."""
    from repro_torch.models.layers import matmul_f32

    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((4, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((4096, 4096), generator=gen, device=cuda) / 64).to(torch.bfloat16)
    out = matmul_f32(h, w)
    assert out.dtype == torch.float32
    ref_ = h.float() @ w.float()
    assert float((out - ref_).abs().max()) <= 1e-4 * float(ref_.abs().max())


def test_float32_product_has_a_derivative(cuda):
    """``torch.mm(out_dtype=float32)`` has no derivative of its own;
    ``matmul_f32``'s ``_MmFloat32`` gives it one: its gradients equal the
    widened product's on the CPU (plain float32 products, cast to
    bfloat16), up to the sums' order."""
    from repro_torch.models.layers import matmul_f32

    gen = torch.Generator().manual_seed(1)
    a = torch.randn((64, 256), generator=gen).to(torch.bfloat16)
    b = (torch.randn((256, 300), generator=gen) / 16).to(torch.bfloat16)
    g = torch.randn((64, 300), generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x, w = a.to(dev).requires_grad_(True), b.to(dev).requires_grad_(True)
        out = matmul_f32(x, w)
        assert out.dtype == torch.float32
        out.backward(g.to(dev))
        grads.append((x.grad.cpu(), w.grad.cpu()))
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    for card_grad, host_grad in zip(*grads):
        # one bfloat16 rounding of float32 sums in two orders: 1 ulp at most
        assert float((card_grad.float() - host_grad.float()).abs().max()) <= (
            2 ** -7 * float(host_grad.float().abs().max()))


def test_train_grads_card_equals_cpu(cuda):
    """hymba-1.5b cut to 2 layers in float32 (its global layer 0 kept):
    the training loss and every gradient on the card against the same
    weights in float64 on the CPU, with each block recomputed in the
    backward pass (``remat_policy`` "nothing", the full config's).  The
    cut's near one-hot attention magnifies float32 rounding (card against
    CPU 3.3e-3 of the largest gradient on the first run), so the card is
    held as the serving cuts are: within 1e-3 of the largest gradient, or
    within 4 times the CPU's own float32 error where that is larger."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm

    full = configs.get_config("hymba_1p5b")
    cfg = dataclasses.replace(full, n_layers=2, dtype="float32", param_dtype_str="float32",
                              cache_dtype_str="float32", global_layers=(0,))
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype_str="float64",
                                cache_dtype_str="float64")
    host = lm.init_lm(cfg, seed=3, device="cpu")
    rows = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(rows[:, :-1]), "labels": torch.from_numpy(rows[:, 1:])}
    out = {}
    for name, c, dev in (("cpu", cfg, torch.device("cpu")), ("card", cfg, cuda),
                         ("float64", cfg64, torch.device("cpu"))):
        model = lm.LM(c, device=dev)
        model.load_state_dict({k: v.to(c.param_dtype) for k, v in host.state_dict().items()})
        model.requires_grad_(True)
        loss, _ = lm.train_loss(model, c, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (float(loss.detach()), [g.cpu().double() for g in grads])
    ref_loss, ref_grads = out["float64"]
    scale = max(float(g.abs().max()) for g in ref_grads)

    def errors(name):
        loss, grads = out[name]
        return abs(loss - ref_loss), max(float((a - b).abs().max())
                                         for a, b in zip(grads, ref_grads))

    (cpu_loss_err, cpu_err), (card_loss_err, card_err) = errors("cpu"), errors("card")
    assert all(bool(torch.isfinite(g).all()) for g in out["card"][1])
    assert card_loss_err <= max(1e-4, 4 * cpu_loss_err), (card_loss_err, cpu_loss_err)
    assert card_err <= max(1e-3 * scale, 4 * cpu_err), (card_err, cpu_err, scale)


def test_vlm_prefill_past_the_cache_raises_on_the_card(cuda):
    """The reference's sizing, ``prompt + 2 + gen + 8``, leaves out the
    VLM's image tokens: a prefill longer than the cache raises before it
    writes (no device assert, no wrapped index)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = dataclasses.replace(configs.get_smoke_config("phi3_vision_4p2b"), n_image_tokens=30)
    server = serve.BatchedServer(cfg, serve.ServeConfig(n_slots=2, max_len=26, gen_tokens=12,
                                                        sampler="greedy"), device=cuda)
    with pytest.raises(ValueError, match="longer than the buffer"):
        server.submit(0, serve.Request(rid=0, prompt=np.arange(4)))
    torch.cuda.synchronize()
    assert not server.cache["layers"]["k"].any()


def test_fma_is_one_rounding_on_the_card(cuda):
    """AdamW's fused multiply-adds (``torch.addcmul``) round once on the
    card too: equal to the emulation ``prng._fma32``."""
    from repro_torch.optim import adamw
    from repro_torch.prng import _fma32

    gen = torch.Generator(device=cuda).manual_seed(0)
    a, b, c = (torch.randn(1_000_003, generator=gen, device=cuda) for _ in range(3))
    ref = _fma32(a, b, c)
    assert torch.equal(adamw.fma(a, b, c), ref)
    w = torch.tensor(np.float32(0.95), device=cuda)
    assert torch.equal(adamw.fma(a, w, c), _fma32(a, w.expand_as(a), c))


# --- the mesh paths on a one-rank nccl mesh (chip_smoke.py phase 36) ------------


@contextlib.contextmanager
def _pod_mesh(cuda):
    """A one-rank ``nccl`` DeviceMesh ("pod", "data", "model") of shape
    (1, 1, 1) on the card, its group destroyed on exit."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=cuda)
    try:
        yield DeviceMesh("cuda", [[[0]]], mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def _llm_cfg(arch, dtype, **kw):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype,
                               param_dtype_str=dtype, cache_dtype_str=dtype, **kw)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_rules_on_one_rank_equal_no_mesh(cuda, dtype):
    """Under ``rules_for_config`` on a one-rank mesh every redistribution
    is the identity: the loss, a prefill and a decode step with the cache
    sharded over its sequence equal the same calls without a mesh,
    tolerance 0, and stay DTensors on the card."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    from repro_torch.models import lm

    # two KV heads: a decode step's score product flattens (B, KV), which
    # DTensor cannot do with both split
    cfg = _llm_cfg("granite3_8b", dtype, n_kv_heads=2,
                   sharding_overrides=(("cache_seq", ("pod", "data", "model")),))
    model = lm.init_lm(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)

    def run():
        with torch.no_grad():
            loss, _ = lm.train_loss(model, cfg, {"tokens": toks, "labels": toks})
        cache = lm.init_cache(cfg, 2, 32, cuda)
        l1, cache = lm.prefill(model, cfg, {"tokens": toks[:, :16]}, cache)
        l2, cache = lm.decode_step(model, cfg, toks[:, 16:17], cache)
        return loss, l1, l2, cache["layers"]["k"]

    want = run()
    with _pod_mesh(cuda) as mesh, sharding.use_mesh(mesh), sharding.use_rules(
            sharding.rules_for_config(cfg)):
        sharding.distribute_params(model, mesh)
        got = run()
        assert all(isinstance(t, DTensor) and t.is_cuda for t in got)
        # the batch takes "pod" and "data", the sequence "model"
        assert [p.is_shard(d) for p, d in zip(got[3].placements, (1, 1, 2))] == [True] * 3
        got = [_whole(t) for t in got]
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_ep_on_one_rank_equals_local(cuda, dtype):
    """moe_ffn_ep on a one-rank mesh against moe_ffn_local without one:
    the output and the gradients of <out, dout>, tolerance 0."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.layers import activation

    cfg = _llm_cfg("qwen3_moe_30b", dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = dict(moe.init_moe(gen, cfg, device=cuda))
    x = torch.randn((2, 16, cfg.d_model), generator=gen, device=cuda).to(cfg.param_dtype)
    dout = torch.randn((2, 16, cfg.d_model), generator=gen, device=cuda).to(cfg.param_dtype)
    leaves = [x.requires_grad_(True), *(p.requires_grad_(True) for p in params.values())]
    y, _ = moe.moe_ffn_local(params, x, cfg, activation(cfg.act))
    want = [y, *torch.autograd.grad(y, leaves, dout)]
    with _pod_mesh(cuda) as mesh, sharding.use_mesh(mesh):
        holder = torch.nn.Module()
        holder.moe = torch.nn.ParameterDict(params)
        holder.param_axes = {f"moe.{n}": p.logical_axes for n, p in params.items()}
        sharding.distribute_params(holder, mesh)
        placed = dict(holder.moe.items())
        xd = sharding.shard(x.detach(), ("batch", "seq", "embed")).requires_grad_(True)
        yd, _ = moe.moe_ffn_ep(placed, xd, cfg, activation(cfg.act), mesh)
        got = [yd, *torch.autograd.grad(yd, [xd, *placed.values()],
                                        sharding.shard(dout, ("batch", "seq", "embed")))]
        got = [_whole(t) for t in got]
    for w, g in zip(want, got):
        assert torch.equal(w.detach(), g)


def test_compressed_step_on_one_rank(cuda):
    """The compressed-pod step on a one-rank mesh: each leaf's reduced
    gradient and new error state equal the plain one-pod version on the
    same gradients (tolerance 0); the pod all-reduce sends int32 words
    and one float32 scale a leaf; then one sampled token through
    make_decode_sample_step on the trained model is one mh_chain launch."""
    from repro_torch.distributed import compression, sharding
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.training import step as step_mod

    cfg = _llm_cfg("hymba_1p5b", "bfloat16")
    model = lm.init_lm(cfg, seed=0, device=cuda)
    held = []
    real = step_mod.compressed_pmean

    def capture(grads, err, **kw):
        red, new_err = real(grads, err, **kw)
        for n, g in grads.items():
            pr, pe = compression.compressed_mean_one_pod({n: g.to_local()},
                                                         {n: err[n].to_local()})
            held.append(torch.equal(pr[n], red[n].to_local())
                        and torch.equal(pe[n], new_err[n].to_local()))
        return red, new_err

    with _pod_mesh(cuda) as mesh:
        fn = step_mod.make_train_step(
            cfg, axes_tree=model.param_axes,
            step_cfg=step_mod.TrainStepConfig(n_micro=2, compress_pods=True), mesh=mesh)
        with sharding.use_mesh(mesh):
            sharding.distribute_params(model, mesh)
            opt = adamw.adamw_init(model)
            err = compression.init_error_state(dict(model.named_parameters()))
        toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator(
            device=cuda).manual_seed(3), device=cuda)
        compression.PAYLOAD.clear()
        step_mod.compressed_pmean = capture
        try:
            for _ in range(2):
                model, opt, metrics, err = fn(model, opt, {"tokens": toks, "labels": toks}, err)
                assert bool(torch.isfinite(metrics["loss"]))
        finally:
            step_mod.compressed_pmean = real
        n_leaves = len(dict(model.named_parameters()))
        n_params = sum(p.numel() for p in model.parameters())
        assert len(held) == 2 * n_leaves and all(held)
        assert dict(compression.PAYLOAD) == {"int32": 2 * 4 * n_params,
                                             "float32": 2 * 4 * n_leaves}
        with sharding.use_mesh(mesh), sharding.use_rules(sharding.rules_for_config(cfg)):
            cache = lm.init_cache(cfg, 4, 40, cuda)
            _, cache = lm.prefill(model, cfg, {"tokens": toks}, cache)
            mh.reset_launches()
            tokens, cache, _ = step_mod.make_decode_sample_step(cfg)(
                model, toks[:, -1:], cache, prng.PRNGKey(5, device=cuda))
            torch.cuda.synchronize()
    assert mh.LAUNCHES["mh_chain"] == 1
    assert tuple(tokens.shape) == (4, 1) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())


# --- the compiled train step: run_training's program a TrainSignature ----------------


def _train_case(cfg, n_micro, device, steps=3):
    """A model, its AdamW state and the step function ``run_training``
    makes for a run of ``steps`` steps (warmup 2, lr 1e-3, seed 0)."""
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    model = lm.init_lm(cfg, 0, device)
    opt_cfg, step_fn = train.run_step_fn(train.TrainRun(cfg=cfg, steps=steps, lr=1e-3, warmup=2,
                                                        n_micro=n_micro))
    return model, adamw_init(model, opt_cfg), step_fn


def _train_batches(cfg, device, steps, rows=4, seq=16):
    from repro_torch.data import DataConfig, SyntheticTokenPipeline

    data = SyntheticTokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                             global_batch=rows, seed=0), device=device)
    return [data.host_batch(t) for t in range(steps)]


@pytest.mark.parametrize("arch,n_micro", [("hymba_1p5b", 1), ("hymba_1p5b", 2),
                                          ("qwen3_moe_30b", 2)])
def test_compiled_train_step_equals_eager(cuda, arch, n_micro, monkeypatch):
    """A smoke config's train step through its program (a capture, then
    replays that call no ``lm.train_loss`` from the host) against the
    eager step on a twin, three steps at tolerance 0: every metric, every
    parameter, the step counter and the moments.  A program refuses a
    state whose tensors were replaced after its capture."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = configs.get_smoke_config(arch)
    model_e, opt_e, fn_e = _train_case(cfg, n_micro, cuda)
    model_c, opt_c, fn_c = _train_case(cfg, n_micro, cuda)
    programs, calls, real_loss = {}, [], lm.train_loss

    def counted(*args):
        calls.append(1)
        return real_loss(*args)

    for t, batch in enumerate(_train_batches(cfg, cuda, 3)):
        _, _, want = fn_e(model_e, opt_e, batch)
        if t:  # the replays: no loss from the host
            monkeypatch.setattr(lm, "train_loss", counted)
        got = train.compiled_step(programs, fn_c, model_c, opt_c, batch, n_micro, cuda)
        monkeypatch.setattr(lm, "train_loss", real_loss)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in train.METRICS), (t, got, want)
        assert all(map(torch.equal, train.state_tensors(model_c, opt_c),
                       train.state_tensors(model_e, opt_e))), t
    assert not calls and int(opt_c["step"]) == 3
    (sig,) = programs
    assert sig.n_micro == n_micro and sig.tokens == ((4, 16), "int32") and sig.frames is None
    assert programs[sig].graph is not None and programs[sig].nbytes > 0
    opt_c["step"] = opt_c["step"].clone()
    with pytest.raises(RuntimeError, match="replaced after the capture"):
        train.compiled_step(programs, fn_c, model_c, opt_c, batch, n_micro, cuda)


def test_checkpoints_keep_no_generator_state_on_the_card(cuda, monkeypatch):
    """The loss's checkpoints keep no generator state (a captured step
    cannot read the card's generator): on the card too, the loss and every
    gradient equal those of checkpoints that save and restore it."""
    from torch.utils import checkpoint as ckpt

    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_smoke_config("hymba_1p5b")
    model = lm.init_lm(cfg, 2, cuda).requires_grad_(True)
    (batch,) = _train_batches(cfg, cuda, 1, rows=2, seq=8)

    def loss_and_grads():
        loss, _ = lm.train_loss(model, cfg, batch)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    def preserving(fn, *args, **kw):
        assert kw.pop("preserve_rng_state") is False
        return ckpt.checkpoint(fn, *args, preserve_rng_state=True, **kw)

    loss, grads = loss_and_grads()
    monkeypatch.setattr(lm, "checkpoint", preserving)
    loss_p, grads_p = loss_and_grads()
    assert torch.equal(loss, loss_p) and all(map(torch.equal, grads, grads_p))


def test_run_training_replays_one_program(cuda, monkeypatch):
    """``run_training`` on the card: one program for its one batch layout,
    captured at the first step and replayed at the others; its losses
    equal those of the eager steps on a twin."""
    from repro_torch import configs, compiled
    from repro_torch.launch import train

    cfg = configs.get_smoke_config("granite3_8b")
    verdicts, real_call = [], compiled.call

    def call(programs, sig, *args, **kw):
        out = real_call(programs, sig, *args, **kw)
        verdicts.append(out[1])
        return out

    monkeypatch.setattr(compiled, "call", call)
    run = train.TrainRun(cfg=cfg, steps=4, global_batch=4, seq_len=16, lr=1e-3, warmup=2,
                         n_micro=2, log_every=100)
    with contextlib.redirect_stdout(io.StringIO()):
        _, opt, losses = train.run_training(run)
    assert verdicts == ["miss", "hit", "hit", "hit"] and int(opt["step"]) == 4
    model_e, opt_e, fn_e = _train_case(cfg, 2, cuda, steps=4)
    want = [float(fn_e(model_e, opt_e, b)[2]["loss"]) for b in _train_batches(cfg, cuda, 4)]
    assert losses == want


def test_compiled_capture_failure_raises(cuda):
    """No eager fallback on a card: a target whose log-prob reads the card
    from the host cannot be captured, and the submit raises naming the
    signature and the failing call."""
    table = torch.randn(2, 64, device=cuda)

    def host_read(words):
        if float(words.float().mean()) < -1:  # a host read of a device value
            raise AssertionError
        return torch.gather(table, 1, words)

    target = samplers.CallableTarget(host_read, nbits=6)
    eng = samplers.MHEngine(samplers.EngineConfig(randomness="fused", execution="scan"))
    plan = samplers.RunPlan(target=target, n_steps=4, init_words=np.zeros((2, 3), np.int64),
                            seed=1)
    with pytest.raises(RuntimeError, match=r"Signature\(.*torch\.cuda\.graph"):
        eng.submit(plan, compiled=True)
    assert not eng._compiled


# --- the compiled server: BatchedServer's decode program and the sampler's ----------


def _serve_mods():
    from repro_torch import compiled, configs
    from repro_torch.core import token_sampler as ts
    from repro_torch.launch import serve
    from repro_torch.models import lm

    return compiled, configs, ts, serve, lm


def _eager_server(serve, lm, ts, cfg, scfg, device):
    """A server with JAX's two jits undone: ``lm.decode_step`` and the
    sampler (on a fresh engine) called directly at every step."""

    class Eager(serve.BatchedServer):
        def _decode(self):
            logits, cache = lm.decode_step(self.model, self.cfg, self.last_tokens, self.cache)
            self.cache["index"].copy_(cache["index"])
            return logits

        def _sample(self, logits):
            keys = prng.split(self.key)
            self.key, sub = keys[0], keys[1]
            engine = samplers.MHEngine(self.sampler_cfg.engine_config(), device=self.device)
            res = ts._sample(engine, self.sampler_cfg, sub, logits[:, :self.cfg.vocab_size],
                             None)
            self.acceptance.append(float(res.acceptance_rate))
            return res.tokens

    return Eager(cfg, scfg, device=device)


def _recorded_drive(server, prompts):
    """``main``'s loop over ``prompts`` (5 requests on 4 slots: a refill,
    and idle slots decoding past the cache), keeping each decode's logits."""
    from repro_torch.launch import serve

    logits, real = [], server._decode

    def decode():
        out = real()
        logits.append(out)
        return out

    server._decode = decode
    queue = [serve.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    finished = []
    while queue or server.active():
        while queue and server.free_slot() is not None:
            server.submit(server.free_slot(), queue.pop(0))
        finished.extend(server.step())
    torch.cuda.synchronize()
    return {r.rid: list(r.out_tokens) for r in finished}, logits


@pytest.mark.parametrize("arch", ["granite3_8b", "qwen3_moe_30b"])
def test_compiled_server_equals_eager(cuda, arch, monkeypatch):
    """A smoke server on the card serves through its decode program and
    the sampler's programs (miss, then hit), and equals a server that
    calls ``lm.decode_step`` and the sampler eagerly, bit for bit: streams,
    every step's logits, the caches, the index and the acceptance."""
    compiled, configs, ts, serve, lm = _serve_mods()
    cfg = configs.get_smoke_config(arch)
    scfg = serve.ServeConfig(n_slots=4, max_len=4 + 2 + 6 + 8, gen_tokens=6, mcmc_steps=8)
    rs = np.random.default_rng(3)
    prompts = [rs.integers(0, cfg.vocab_size, size=4 + i % 3) for i in range(5)]
    verdicts = []
    real_call = compiled.call

    def call(programs, sig, *args, **kw):
        out = real_call(programs, sig, *args, **kw)
        verdicts.append((type(sig).__name__, out[1]))
        return out

    with torch.inference_mode():
        want = _recorded_drive(_eager_server(serve, lm, ts, cfg, scfg, cuda), prompts)
    ts.clear_cache()
    monkeypatch.setattr(compiled, "call", call)
    server = serve.BatchedServer(cfg, scfg, device=cuda)
    eager = _eager_server(serve, lm, ts, cfg, scfg, cuda)
    with torch.inference_mode():
        got = _recorded_drive(server, prompts)
        again = _recorded_drive(eager, prompts)
    assert got[0] == want[0] == again[0]
    assert len(got[1]) == len(want[1]) and all(map(torch.equal, got[1], want[1]))
    assert server.acceptance == eager.acceptance
    leaves, eager_leaves = [], []
    lm.tree_map(leaves.append, server.cache["layers"])
    lm.tree_map(eager_leaves.append, eager.cache["layers"])
    assert all(map(torch.equal, leaves, eager_leaves))
    assert torch.equal(server.cache["index"], eager.cache["index"])
    decode = [v for n, v in verdicts if n == "DecodeSignature"]
    sample = [v for n, v in verdicts if n == "Signature"]
    assert decode == ["miss"] + ["hit"] * (len(decode) - 1) and len(decode) == len(got[1])
    assert sample.count("miss") == 2 and sample[0] == "miss"  # B = 1, then B = 4
    assert ts.cache_size() == 2 and len(server._programs) == 1
    (program,) = server._programs.values()
    assert program.graph is not None and program.nbytes > 0
    assert all(p.graph is not None and p.launches[0]["mh_chain"] == 1
               for p in ts._PROGRAMS.values())


def test_compiled_server_results_survive_replays(cuda):
    """A replayed step's logits and a replayed sample are the caller's
    own: later replays on other inputs change nothing in them.  A program
    never reads a model that replaced the one it captured with."""
    _, configs, ts, serve, lm = _serve_mods()
    cfg = configs.get_smoke_config("granite3_8b")
    server = serve.BatchedServer(cfg, serve.ServeConfig(n_slots=2, max_len=24, gen_tokens=8,
                                                        mcmc_steps=8), device=cuda)
    rs = np.random.default_rng(4)
    v = cfg.vocab_size
    with torch.inference_mode():
        for slot in range(2):
            server.submit(slot, serve.Request(rid=slot, prompt=rs.integers(0, 200, size=5)))
        server._decode()  # the capture
        first = server._decode()  # a replay
        kept = first.clone()
        ts._sample_tokens_impl(server.key, first[:, :v], server.sampler_cfg)
        sample = ts._sample_tokens_impl(server.key, first[:, :v], server.sampler_cfg)
        kept_sample = [x.clone() for x in sample]
        for _ in range(3):
            server.step()
        other = ts._sample_tokens_impl(prng.PRNGKey(9, device=cuda), first[:, :v] * 0.5,
                                       server.sampler_cfg)
        torch.cuda.synchronize()
        assert torch.equal(first, kept)
        assert all(map(torch.equal, sample, kept_sample))
        assert not torch.equal(other.final_logp, sample.final_logp)
        server.model = lm.init_lm(cfg, 1, cuda)
        with pytest.raises(RuntimeError, match="replaced after the capture"):
            server.step()


def test_dropped_server_and_sampler_cache_free_their_graphs(cuda):
    """The decode programs die with their server, the sampler's with
    ``clear_cache``: afterwards nothing they held stays allocated."""
    import gc

    _, configs, ts, serve, _ = _serve_mods()
    cfg = configs.get_smoke_config("qwen3_moe_30b")
    scfg = serve.ServeConfig(n_slots=4, max_len=24, gen_tokens=4, mcmc_steps=8)
    prompts = [np.arange(5) + i for i in range(5)]

    def drive():
        server = serve.BatchedServer(cfg, scfg, device=cuda)
        with torch.inference_mode():
            out = _recorded_drive(server, prompts)[0]
        assert len(server._programs) == 1 and ts.cache_size() == 2
        return out

    def settled():
        ts.clear_cache()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(cuda)

    ts.clear_cache()
    first = drive()  # builds the kernels and every cached table first
    before = settled()
    assert drive() == first
    assert settled() == before


def test_compiled_server_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a decode or a sample that reads the
    card from the host cannot be captured, and the call raises naming its
    signature; nothing is kept."""
    _, configs, ts, serve, lm = _serve_mods()
    cfg = configs.get_smoke_config("granite3_8b")
    scfg = serve.ServeConfig(n_slots=2, max_len=24, gen_tokens=4, mcmc_steps=8)
    server = serve.BatchedServer(cfg, scfg, device=cuda)
    real_decode, real_sample = lm.decode_step, ts._sample

    def host_read_decode(*args):
        logits, cache = real_decode(*args)
        if float(logits.sum()) != float(logits.sum()):  # a host read of a device value
            raise AssertionError
        return logits, cache

    def host_read_sample(*args):
        out = real_sample(*args)
        if float(out.acceptance_rate) < 0:
            raise AssertionError
        return out

    with torch.inference_mode():
        server.submit(0, serve.Request(rid=0, prompt=np.arange(5)))
        # drawn before the failures: after a failed capture PyTorch leaves
        # the default CUDA generator in its capturing state, and a draw
        # from it raises
        logits = torch.randn(2, cfg.vocab_size, device=cuda)
        monkeypatch.setattr(lm, "decode_step", host_read_decode)
        with pytest.raises(RuntimeError, match=r"DecodeSignature\(.*torch\.cuda\.graph"):
            server.step()
        assert not server._programs
        monkeypatch.setattr(lm, "decode_step", real_decode)
        ts.clear_cache()
        monkeypatch.setattr(ts, "_sample", host_read_sample)
        with pytest.raises(RuntimeError, match=r"token sampler Signature\(.*torch\.cuda\.graph"):
            ts._sample_tokens_impl(prng.PRNGKey(1, device=cuda), logits, server.sampler_cfg)
        assert ts.cache_size() == 0


def test_compiled_train_step_capture_failure_raises(cuda):
    """No eager fallback on the card: a step function that copies from
    the host cannot be captured; the step raises naming its
    ``TrainSignature``, and nothing is kept."""
    from repro_torch import configs
    from repro_torch.launch import train

    cfg = configs.get_smoke_config("granite3_8b")
    model, opt, step_fn = _train_case(cfg, 1, cuda)

    def copying(model_, opt_, batch_):
        out = step_fn(model_, opt_, batch_)
        out[2]["loss"] = out[2]["loss"] + torch.tensor(np.float32(0.0), device=cuda)
        return out

    programs = {}
    (batch,) = _train_batches(cfg, cuda, 1)
    with pytest.raises(RuntimeError, match=r"train step TrainSignature\(.*torch\.cuda\.graph"):
        train.compiled_step(programs, copying, model, opt, batch, 1, cuda)
    assert not programs


def test_compiled_advance_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a kernel advance whose body copies
    from the host cannot be captured; the chunk raises naming its
    ``(seg, collect)``, and nothing is kept."""
    from repro_torch import serving
    from repro_torch.kernels.mh import ops as mh_ops

    real = mh_ops.mh_sample_fused

    def copying(*args, **kw):
        samples, acc = real(*args, **kw)
        return samples + torch.tensor(0, dtype=torch.int64, device=cuda), acc

    ex = serving.PackedExecutor.for_workload("gmm", n_slots=2, randomness="fused",
                                             execution="pallas", smoke=True, chunk_steps=8)
    ex.admit(serving.ServeRequest(rid=0, workload="gmm", n_steps=16, seed=1, collect="all"))
    monkeypatch.setattr(mh_ops, "mh_sample_fused", copying)
    with pytest.raises(RuntimeError,
                       match=r"packed mh advance \(seg=8, collect='all'\): .*torch\.cuda\.graph"):
        ex.advance_chunk()
    assert not ex._advance.programs


def test_scan_class_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a scan class advance whose body
    copies from the host cannot be captured; the chunk raises naming its
    ``(seg, collect)``, and nothing is kept."""
    from repro_torch import serving
    from repro_torch.samplers import engine as engine_mod

    real = engine_mod._mh_step

    def copying(*args):
        words, logp, acc = real(*args)
        return words + torch.tensor(0, dtype=torch.int64, device=cuda), logp, acc

    ex = serving.PackedExecutor.for_workload("gmm", n_slots=2, randomness="fused",
                                             execution="scan", smoke=True, chunk_steps=8)
    ex.admit(serving.ServeRequest(rid=0, workload="gmm", n_steps=16, seed=1, collect="all"))
    monkeypatch.setattr(engine_mod, "_mh_step", copying)
    with pytest.raises(RuntimeError,
                       match=r"scan class advance \(seg=8, collect='all'\): .*torch\.cuda\.graph"):
        ex.advance_chunk()
    assert not ex._advance.programs
