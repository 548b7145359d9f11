"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports only torch and the port (no JAX), so it runs on a machine
that has the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

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
        k_init, k_run = prng.split(prng.PRNGKey(r.seed, device=cuda))
        wl = workloads.build(workload, k_init, randomness=randomness, backend="pallas",
                             smoke=True)
        ref_ = wl.engine.run(k_run, wl.target, r.n_steps, wl.init_words, collect=r.collect)
        assert np.array_equal(r.samples, ref_.samples.cpu().numpy())
        assert np.array_equal(r.final_words, ref_.final_words.cpu().numpy())
        assert np.array_equal(r.accept_count, ref_.accept_count.cpu().numpy())


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
@pytest.mark.parametrize("arch", ["hymba_1p5b", "mamba2_1p3b", "qwen3_moe_30b"])
def test_family_server_card_equals_cpu(cuda, arch, sampler):
    """The MoE, SSM and hybrid smoke servers (the prompts of
    tests/test_torch_serve.py's family cases)."""
    _server_card_equals_cpu(cuda, sampler, arch, prompt_seed=4)


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
