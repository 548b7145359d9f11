"""The port's MoE FFN (``repro_torch.models.moe``) and MoE block against
the JAX package's (``tests/test_models.py:TestMoE``).

The same inputs, made from a seed with numpy, go through the JAX function
and its port, in float32 on the CPU; weights cross as numpy arrays.
Routing is discrete, so the chosen experts and the capacity drops (the
kept slots) are held exactly, ties and overflow included; the float
results are held within the largest absolute difference measured on
these inputs (jax 0.9.0, torch 2.13.0, CPU), rounded up, with the
measurement in a comment beside each.
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
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.models import blocks, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation

COMMON = dict(dtype="float32", param_dtype_str="float32", cache_dtype_str="float32",
              attn_block_q=8, attn_block_kv=8, logits_chunk=16, remat_policy="none")
# tests/test_models.py:TestMoE's layer
SMALL = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
             d_ff=16, vocab_size=64, n_experts=4, moe_top_k=2, **COMMON)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _assert_close(jax_out, torch_out, tol, what=""):
    assert tuple(np.shape(jax_out)) == tuple(torch_out.shape), what
    diff = float(np.max(np.abs(np.asarray(jax_out) - torch_out.detach().numpy())))
    assert diff <= tol, f"{what}: max |JAX - port| = {diff} > {tol}"


def _cfgs(**kw):
    base = {**SMALL, **kw}
    return JModelConfig(**base), ModelConfig(**base)


def _moe_params(cfg, seed):
    """JAX's ``init_moe`` values and the same as torch tensors."""
    values, _ = jlayers.split_annotated(jmoe.init_moe(jax.random.PRNGKey(seed), cfg))
    return values, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in values.items()}


def test_capacity():
    for s in (1, 7, 16, 100, 128, 130, 4096):
        for e, k in ((4, 2), (8, 2), (128, 8), (16, 2)):
            for f in (0.5, 1.0, 1.25, 2.0, 8.0):
                assert moe.capacity(s, e, k, f) == jmoe.capacity(s, e, k, f), (s, e, k, f)
    # a decode step of qwen3-moe-30b: S = 1, capacity 8; a 128-token prefill: 16
    assert moe.capacity(1, 128, 8, 1.25) == 8 and moe.capacity(128, 128, 8, 1.25) == 16


@pytest.mark.parametrize("renormalize", [True, False])
def test_route(renormalize):
    jcfg, _ = _cfgs(n_experts=16, moe_top_k=4)
    router = _normal(0, (32, 16), 1 / np.sqrt(32))
    x = _normal(1, (3, 40, 32))
    jp, je, jaux = jmoe.route(router, x, 4, renormalize=renormalize)
    tp, te, taux = moe.route(torch.from_numpy(router), torch.from_numpy(x), 4,
                             renormalize=renormalize)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    # measured: probs 2.4e-7 (renormalised) and 1.2e-7, for probabilities
    # up to 0.75; aux 1.2e-7 (aux 1.07)
    _assert_close(jp, tp, 5e-7, "probs")
    _assert_close(jaux, taux, 5e-7, "aux")


def test_route_ties_take_the_lower_expert():
    """An all-zero router ties every probability: lax.top_k takes the
    lower ids first, and so must the port (the experts are 0..k-1)."""
    x = _normal(2, (4, 64, 32))
    zero = np.zeros((32, 8), np.float32)
    jp, je, jaux = jmoe.route(zero, x.reshape(-1, 32), 3)
    tp, te, taux = moe.route(torch.from_numpy(zero), torch.from_numpy(x.reshape(-1, 32)), 3)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    assert (te == torch.arange(3)).all()
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert float(jaux) == float(taux) == pytest.approx(1.0)
    # partial ties: two equal logits columns among others
    router = _normal(3, (32, 8), 1 / np.sqrt(32))
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    je = np.asarray(jmoe.route(router, x.reshape(-1, 32), 3)[1])
    te = moe.route(torch.from_numpy(router), torch.from_numpy(x.reshape(-1, 32)), 3)[1]
    np.testing.assert_array_equal(je, te.numpy())


def _jax_slots(x, probs, experts, cfg, cap):
    """JAX's per-row dispatch under ``vmap``: the kept slots (E*cap when
    dropped) in sorted order."""
    fn = jax.vmap(lambda xr, pr, er: jmoe._dispatch_row(xr, pr, er, cfg.n_experts, cfg.moe_top_k,
                                                        cap, 0))
    bufs, (slot, tok, weights) = fn(x, probs, experts)
    return np.asarray(bufs), np.asarray(slot), np.asarray(tok), np.asarray(weights)


@pytest.mark.parametrize("cap_factor", [8.0, 0.5])
def test_moe_ffn_local(cap_factor):
    """At 8.0 nothing drops; at 0.5 the capacity is 8 against a mean load
    of 8 a row, so overfull experts drop their later tokens: the same
    slots as JAX's, the same output and aux."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=cap_factor)
    values, tp = _moe_params(jcfg, 0)
    x = _normal(4, (2, 16, 32))
    act = "silu"
    ref, jaux = jmoe.moe_ffn_local(values, x, jcfg, jlayers.activation(act))
    out, taux = moe.moe_ffn_local(tp, torch.from_numpy(x), tcfg, activation(act))
    # measured: out 3.6e-7 at both factors (outputs up to 2.6); aux 0,
    # held to one ULP at 1.0
    _assert_close(ref, out, 1e-6, "out")
    _assert_close(jaux, taux, 1.2e-7, "aux")

    probs, experts, _ = jmoe.route(values["router"], x, 2)
    cap = jmoe.capacity(16, 4, 2, cap_factor)
    jbuf, jslot, jtok, jw = _jax_slots(x, probs, experts, jcfg, cap)
    tbuf, (tslot, ttok, tw) = moe._dispatch(
        torch.from_numpy(x), torch.from_numpy(np.array(probs)),
        torch.from_numpy(np.asarray(experts).astype(np.int64)), 4, 2, cap)
    np.testing.assert_array_equal(jslot, tslot.numpy())
    np.testing.assert_array_equal(jtok, ttok.numpy())
    np.testing.assert_array_equal(jw, tw.numpy())
    np.testing.assert_array_equal(jbuf, tbuf.numpy())
    drops = int((jslot == 4 * cap).sum())
    assert drops == 0 if cap_factor == 8.0 else drops > 0, drops


def test_capacity_path_equals_dense_reference():
    """tests/test_models.py:test_capacity_dispatch_matches_dense on the
    port, and the port's dense oracle against JAX's."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=8.0)
    values, tp = _moe_params(jcfg, 0)
    x = _normal(5, (2, 16, 32))
    out, _ = moe.moe_ffn_local(tp, torch.from_numpy(x), tcfg, activation("silu"))
    dense = moe.moe_dense_reference(tp, torch.from_numpy(x), tcfg, activation("silu"))
    # measured: 0 (port against port: the same sums in the same order);
    # 2.4e-7 against JAX's oracle (outputs up to 2.2)
    assert torch.equal(out, dense)
    _assert_close(jmoe.moe_dense_reference(values, x, jcfg, jlayers.activation("silu")), dense,
                  5e-7, "dense")


def test_moe_ffn_with_a_mesh_refuses():
    _, tcfg = _cfgs()
    _, tp = _moe_params(JModelConfig(**SMALL), 0)
    with pytest.raises(NotImplementedError, match="queue 1 item 10g"):
        moe.moe_ffn(tp, torch.zeros((1, 2, 32)), tcfg, activation("silu"), mesh=object())


def test_init_moe_dtypes_and_scales():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3_moe_30b"), param_dtype_str="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3_moe_30b"),
                               param_dtype_str="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert tuple(p["w_gate"].shape) == (8, 64, 16) and tuple(p["w_down"].shape) == (8, 16, 64)
    assert p["w_gate"].logical_axes == ("experts", "embed", "ffn")
    jv, _ = jlayers.split_annotated(jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jv.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in p.items()}


# --- the block ----------------------------------------------------------------------


def _block_from(values, cfg, kind):
    """The port's block holding a JAX block's values."""
    block = blocks.init_block(None, cfg, kind=kind, device="cpu")
    with torch.no_grad():
        for name, p in block.named_parameters():
            node = values
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.from_numpy(np.asarray(node).copy()))
    return block


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_moe_block(mode):
    """The qwen3-moe smoke block (qk_norm, 8 experts top-2), prefill
    writing the KV cache and a decode step at a per-row index."""
    jcfg = jconfigs.get_smoke_config("qwen3_moe_30b")
    tcfg = configs.get_smoke_config("qwen3_moe_30b")
    values, _ = jlayers.split_annotated(jblocks.init_block(jax.random.PRNGKey(6), jcfg))
    block = _block_from(values, tcfg, "moe")
    b, s, smax = 2, (11 if mode == "full" else 1), 16
    x = _normal(7, (b, s, 64))
    kc, vc = _normal(8, (b, smax, 2, 16)), _normal(9, (b, smax, 2, 16))
    idx = np.array([3, 9], np.int32)
    pos = idx[:, None] if mode == "decode" else np.arange(s, dtype=np.int32)
    ref, jcache, jaux = jblocks.apply_block(
        values, x, jcfg, mode=mode, positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, cache_index=jnp.asarray(idx))
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, tnew, taux = block(torch.from_numpy(x), mode=mode, positions=torch.from_numpy(pos),
                            cache=tcache, cache_index=torch.from_numpy(idx))
    # measured: out 9.5e-6 (full, outputs up to 31: the smoke wq's scale
    # is 1/sqrt(4)) and 2.6e-6 (decode, up to 8.5); cache 6.0e-7 (entries
    # up to 3.2); aux 2.4e-7 and 4.8e-7 (aux up to 5.7)
    _assert_close(ref, out, 2e-5 if mode == "full" else 5e-6, "out")
    _assert_close(jcache["k"], tnew["k"], 1e-6, "k")
    _assert_close(jaux, taux, 1e-6, "aux")
