"""The port's Mamba-2 layer (``repro_torch.models.ssm``) and the SSM and
hybrid blocks against the JAX package's (``tests/test_models.py:TestSSM``).

The same inputs, made from a seed with numpy, go through the JAX function
and its port, in float32 on the CPU; weights cross as numpy arrays.  Each
tolerance is the largest absolute difference measured on these inputs
(jax 0.9.0, torch 2.13.0, CPU), rounded up, with the measurement in a
comment beside it.

The reference's chunked SSD gives NaN once a chunk's accumulated decay
passes ~88 (``src/repro/models/ssm.py:149-150``: the exponent is taken
before the causal mask, and inf * 0 is NaN); ``test_long_chunk_*`` shows
it, and holds the port, which masks first, to JAX's step recurrence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.models import blocks, ssm
from repro_torch.models.config import ModelConfig

COMMON = dict(dtype="float32", param_dtype_str="float32", cache_dtype_str="float32",
              attn_block_q=8, attn_block_kv=8, logits_chunk=16, remat_policy="none")
# tests/test_models.py:TestSSM's layer
SMALL = dict(name="s", family="ssm", n_layers=1, d_model=32, vocab_size=64, ssm_heads=4,
             ssm_head_dim=8, ssm_state=8, ssm_chunk=8, **COMMON)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _assert_close(jax_out, torch_out, tol, what=""):
    assert tuple(np.shape(jax_out)) == tuple(torch_out.shape), what
    diff = float(np.max(np.abs(np.asarray(jax_out) - torch_out.detach().numpy())))
    assert diff <= tol, f"{what}: max |JAX - port| = {diff} > {tol}"


def _cfgs(**kw):
    base = {**SMALL, **kw}
    return JModelConfig(**base), ModelConfig(**base)


def _mamba(cfg, seed):
    """JAX's ``init_mamba2`` values and the same as torch tensors."""
    values, _ = jlayers.split_annotated(jssm.init_mamba2(jax.random.PRNGKey(seed), cfg))
    return values, {k: _t(v) for k, v in values.items()}


def _cache_close(jcache, tcache, tol, what):
    assert sorted(jcache) == sorted(tcache)
    for name in jcache:
        assert str(tcache[name].dtype) == f"torch.{jcache[name].dtype.name}", name
        _assert_close(jcache[name], tcache[name], tol, f"{what} {name}")


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_full(with_cache):
    x, w = _normal(0, (2, 9, 3, 5)), _normal(1, (4, 3, 5), 0.5)
    cache = _normal(2, (2, 3, 3, 5)) if with_cache else None
    ref, jc = jssm._causal_conv_full(x, w, cache)
    out, tc = ssm._causal_conv_full(_t(x), _t(w), None if cache is None else _t(cache))
    # measured: 0 with and without the cache (the same products and adds in
    # the same order); the carried inputs are the inputs
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


@pytest.mark.parametrize("s", [24, 20])  # the chunk (8) divides 24, not 20
def test_mamba2_full(s):
    jcfg, tcfg = _cfgs()
    values, tp = _mamba(jcfg, 0)
    x = _normal(3, (2, s, 32))
    ref, _ = jssm.mamba2_full(values, x, jcfg)
    out, _ = ssm.mamba2_full(tp, _t(x), tcfg)
    # measured: out 3.1e-6 (S = 24) and 2.1e-6 (S = 20), for outputs up to
    # 7.1; the carried state 1.5e-5 (entries up to 67), the conv inputs
    # 3.8e-6 (up to 15)
    _assert_close(ref, out, 5e-6, "out")
    # and with a cache: the state and conv inputs after the sequence
    jcache = jssm.init_ssm_cache(jcfg, 2, dtype=jnp.float32)
    tcache = ssm.init_ssm_cache(tcfg, 2, dtype=torch.float32)
    ref, jnew = jssm.mamba2_full(values, x, jcfg, jcache)
    out, tnew = ssm.mamba2_full(tp, _t(x), tcfg, tcache)
    assert tnew is tcache  # written in place
    _assert_close(ref, out, 5e-6, "out, cache")
    _cache_close(jnew, tnew, 2e-5, "cache")


def test_prefill_then_decode():
    """tests/test_models.py:test_prefill_then_decode_matches_full on both
    sides: prefill 8 tokens into the cache, then 8 decode steps."""
    jcfg, tcfg = _cfgs()
    values, tp = _mamba(jcfg, 2)
    x = _normal(4, (2, 16, 32))
    jcache = jssm.init_ssm_cache(jcfg, 2, dtype=jnp.float32)
    tcache = ssm.init_ssm_cache(tcfg, 2, dtype=torch.float32)
    jy, jcache = jssm.mamba2_full(values, x[:, :8], jcfg, jcache)
    ty, tcache = ssm.mamba2_full(tp, _t(x[:, :8]), tcfg, tcache)
    # measured: prefill 1.4e-6, steps 4.8e-6 at most (outputs up to 6.9);
    # the state 1.9e-5 (entries up to 53), the conv inputs 2.4e-6
    _assert_close(jy, ty, 5e-6, "prefill")
    for t in range(8, 16):
        jy, jcache = jssm.mamba2_decode(values, x[:, t:t + 1], jcfg, jcache)
        ty, tcache = ssm.mamba2_decode(tp, _t(x[:, t:t + 1]), tcfg, tcache)
        _assert_close(jy, ty, 5e-6, f"step {t}")
    _cache_close(jcache, tcache, 2e-5, "cache")


@pytest.mark.parametrize("n_layers,dtype", [(None, jnp.float32), (3, jnp.bfloat16)])
def test_init_ssm_cache(n_layers, dtype):
    jcfg, tcfg = _cfgs(ssm_groups=2, ssm_conv=3)
    jc = jssm.init_ssm_cache(jcfg, 5, n_layers=n_layers, dtype=dtype)
    tc = ssm.init_ssm_cache(tcfg, 5, n_layers=n_layers, dtype=getattr(torch, dtype.dtype.name),
                            device="cpu")
    assert sorted(jc) == sorted(tc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype) == f"torch.{jc[name].dtype.name}", name
        assert not tc[name].any()


def test_init_mamba2_dtypes_and_scales():
    cfg = dataclasses.replace(configs.get_smoke_config("mamba2_1p3b"), param_dtype_str="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("mamba2_1p3b"),
                               param_dtype_str="bfloat16")
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    jv, _ = jlayers.split_annotated(jssm.init_mamba2(jax.random.PRNGKey(0), jcfg))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jv.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in p.items()}
    assert torch.equal(p["A_log"], torch.zeros(4)) and torch.equal(p["D"], torch.ones(4))
    # conv leaves: normal x 0.5 over 4 x 4 x 16 = 256 draws
    assert 0.4 < float(p["conv_x"].float().std()) < 0.6


def test_long_chunk_reference_nans_and_port_is_finite():
    """The smoke mamba2 layer with ``ssm_chunk=256`` at S = 130: one chunk
    of 130 steps, whose accumulated decay passes ~88.  The reference's
    chunked output has NaN there; the port's is finite and equals JAX's
    step recurrence (``mamba2_reference``)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("mamba2_1p3b"), ssm_chunk=256)
    tcfg = dataclasses.replace(configs.get_smoke_config("mamba2_1p3b"), ssm_chunk=256)
    values, tp = _mamba(jcfg, 0)
    x = _normal(5, (1, 130, 64))
    chunked, _ = jssm.mamba2_full(values, x, jcfg)
    nan_rows = np.isnan(np.asarray(chunked)).any(axis=-1)[0]
    assert nan_rows.any(), "the reference's chunked SSD no longer gives NaN here"
    recurrence = jssm.mamba2_reference(values, x, jcfg)
    out, _ = ssm.mamba2_full(tp, _t(x), tcfg)
    assert torch.isfinite(out).all()
    # measured: 24 of 130 rows NaN in the reference; the port 1.1e-5 from
    # the recurrence and 1.3e-5 from the reference's finite rows (outputs
    # up to 8.0)
    _assert_close(recurrence, out, 2e-5, "against the recurrence")
    # where the reference is finite, the port gives its value
    _assert_close(np.asarray(chunked)[:, ~nan_rows], out[:, ~nan_rows], 2e-5, "finite rows")


# --- the blocks ---------------------------------------------------------------------


def _block_from(values, cfg, kind):
    """The port's block holding a JAX block's values."""
    block = blocks.init_block(None, cfg, kind=kind, device="cpu")
    with torch.no_grad():
        for name, p in block.named_parameters():
            node = values
            for key in name.split("."):
                node = node[key]
            p.copy_(_t(node))
    return block


def _tree_close(jtree, ttree, tol, what):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), what
        for k in jtree:
            _tree_close(jtree[k], ttree[k], tol, f"{what}/{k}")
    else:
        _assert_close(jtree, ttree, tol, what)


@pytest.mark.parametrize("arch,kind", [("mamba2_1p3b", "ssm"), ("hymba_1p5b", "hybrid")])
def test_ssm_and_hybrid_blocks(arch, kind):
    """Prefill 13 tokens into a fresh cache, then 2 decode steps at a
    per-row index.  The hybrid runs as a windowed (non-global) layer of
    hymba's smoke config, whose window of 8 binds at 13 tokens; its global
    layer runs in the whole LM (tests/test_torch_models.py)."""
    is_global = False
    jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    values, _ = jlayers.split_annotated(jblocks.init_block(jax.random.PRNGKey(7), jcfg))
    block = _block_from(values, tcfg, kind)
    b, s, smax = 2, 13, 16
    x = _normal(8, (b, s + 2, 64))
    meta = {"is_global": is_global} if kind == "hybrid" else None

    def jax_cache():
        from repro.models import lm as jlm
        layers = jlm._layer_cache(dataclasses.replace(jcfg, n_layers=1), b, smax)
        return jax.tree.map(lambda a: a[0], layers)

    def port_cache():
        from repro_torch.models import lm
        layers = lm._layer_cache(dataclasses.replace(tcfg, n_layers=1), b, smax, "cpu")
        return lm.tree_map(lambda a: a[0], layers)

    jc, tc = jax_cache(), port_cache()
    jmeta = None if meta is None else {"is_global": jnp.asarray(is_global)}
    pos = np.arange(s, dtype=np.int32)
    ref, jc, _ = jblocks.apply_block(values, x[:, :s], jcfg, mode="full", positions=pos,
                                     cache=jc, cache_index=jnp.int32(0), meta=jmeta)
    out, tc, aux = block(_t(x[:, :s]), mode="full", positions=_t(pos), cache=tc,
                         cache_index=torch.tensor(0, dtype=torch.int32), meta=meta)
    assert aux == 0.0
    # measured: ssm prefill 3.2e-6, steps 2.0e-6 (outputs up to 8.8), cache
    # 6.1e-5 (the state, entries up to 258); hybrid prefill 2.1e-4, steps
    # 7.1e-5 (outputs up to 63: the attention branch, 8.2e-5 alone, whose
    # near one-hot softmax magnifies its scores' rounding), cache 2.3e-5
    tol, cache_tol = (5e-6, 1e-4) if kind == "ssm" else (3e-4, 5e-5)
    _assert_close(ref, out, tol, "prefill")
    idx = np.array([s, s], np.int32)
    for t in range(2):
        step = x[:, s + t:s + t + 1]
        ref, jc, _ = jblocks.apply_block(values, step, jcfg, mode="decode",
                                         positions=jnp.asarray(idx + t)[:, None], cache=jc,
                                         cache_index=jnp.asarray(idx + t), meta=jmeta)
        out, tc, _ = block(_t(step), mode="decode", positions=_t(idx + t)[:, None], cache=tc,
                           cache_index=_t(idx + t), meta=meta)
        _assert_close(ref, out, tol, f"step {t}")
    _tree_close(jc, tc, cache_tol, "cache")
