"""The port's model layers against the JAX package's (``tests/test_models.py``).

The same inputs, made from a seed with numpy, go through the JAX function
and its port, in float32 on the CPU.  Weights cross through
``convert.lm_from_numpy``.  Each tolerance is the largest absolute
difference measured on these inputs (jax 0.9.0, torch 2.13.0, CPU),
rounded up, and the comment beside it gives the measurement: the two
sides sum in different orders and their ``exp``, ``cos``, ``sin`` and
``rsqrt`` may differ in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs, convert
from repro_torch.models import attention as attn
from repro_torch.models import blocks, layers, lm
from repro_torch.models.config import ModelConfig

COMMON = dict(
    dtype="float32",
    param_dtype_str="float32",
    cache_dtype_str="float32",
    attn_block_q=8,
    attn_block_kv=8,
    logits_chunk=16,
    remat_policy="none",
)
# tests/test_models.py's per-row-index model
PER_ROW = dict(name="d", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
               d_head=16, d_ff=64, vocab_size=100, **COMMON)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _max_diff(jax_out, torch_out) -> float:
    return float(np.max(np.abs(np.asarray(jax_out) - torch_out.detach().numpy())))


def _assert_close(jax_out, torch_out, tol, what=""):
    assert tuple(np.shape(jax_out)) == tuple(torch_out.shape), what
    diff = _max_diff(jax_out, torch_out)
    assert diff <= tol, f"{what}: max |JAX - port| = {diff} > {tol}"


def _params(tree) -> torch.nn.ParameterDict:
    values, _ = jlayers.split_annotated(tree)
    return torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(np.asarray(v).copy()), requires_grad=False)
        for k, v in values.items()
    })


# --- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(configs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), (arch, get)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_and_properties(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    for active in (False, True):
        assert t.param_count(active) == j.param_count(active)
        assert t.layer_params(active) == j.layer_params(active)
    for prop in ("padded_vocab", "has_attention", "has_mlp", "is_encdec", "sub_quadratic"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for prop in ("param_dtype", "cache_dtype", "compute_dtype"):
        assert str(getattr(t, prop)) == f"torch.{getattr(j, prop).name}", prop


def test_registry_and_shapes():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.ARCH_ALIASES == jconfigs.ARCH_ALIASES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.assigned_cells() == jconfigs.assigned_cells()
    assert configs.get_config("granite-3-8b") == configs.get_config("granite3_8b")
    with pytest.raises(ValueError):
        ModelConfig(name="x", family="dense", n_layers=1, d_model=8, dtype="nope").compute_dtype


def test_granite_full_width_shape():
    cfg = configs.get_config("granite3_8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab) == (40, 4096, 32, 8, 128, 12800, 49155, 49408)
    assert cfg.param_dtype == torch.bfloat16


# --- layers ----------------------------------------------------------------------


def test_norms():
    x, w, b = _normal(0, (3, 5, 64), 3.0), _normal(1, (64,)), _normal(2, (64,))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    # measured: rms_norm 7.2e-7, layer_norm 4.8e-7 (outputs up to 8.1)
    _assert_close(jlayers.rms_norm(x, w, 1e-5), layers.rms_norm(xt, wt, 1e-5), 2e-6, "rms")
    _assert_close(jlayers.layer_norm(x, w, b, 1e-5), layers.layer_norm(xt, wt, bt, 1e-5),
                  2e-6, "layer_norm")


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "gelu_tanh"])
def test_activation(name):
    x = _normal(3, (4, 33), 3.0)
    # measured: 4.8e-7 at most (0 for relu; outputs up to 10)
    _assert_close(jlayers.activation(name)(x), layers.activation(name)(torch.from_numpy(x)),
                  1e-6, name)


@pytest.mark.parametrize("d_head,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope(d_head, theta):
    np.testing.assert_array_equal(np.asarray(jlayers.rope_frequencies(d_head, theta)),
                                  layers.rope_frequencies(d_head, theta).numpy())
    x = _normal(4, (2, 3, 37, d_head))
    pos = np.random.default_rng(5).integers(0, 200, (2, 3, 37)).astype(np.int32)
    # measured: 2.4e-7 (d_head 16), 4.8e-7 (d_head 128): cos and sin of
    # angles up to 200
    _assert_close(jlayers.apply_rope(x, pos, theta),
                  layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
                  1e-6, "rope")


def test_init_rule_scale():
    """normal x 1/sqrt(shape[-2]): wq (d, h, dh) gets 1/sqrt(h), not
    1/sqrt(d); w_down (f, d) 1/sqrt(f); the embedding 1; norms ones."""
    cfg = ModelConfig(name="s", family="dense", n_layers=1, d_model=512, n_heads=4,
                      n_kv_heads=2, d_head=64, d_ff=1024, vocab_size=4096, **COMMON)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    block = model.layers[0]
    want = {
        "wq": (block["attn"]["wq"], 1 / np.sqrt(4)),
        "wk": (block["attn"]["wk"], 1 / np.sqrt(2)),
        "wo": (block["attn"]["wo"], 1 / np.sqrt(64)),
        "w_gate": (block["mlp"]["w_gate"], 1 / np.sqrt(512)),
        "w_down": (block["mlp"]["w_down"], 1 / np.sqrt(1024)),
        "embed": (model.embed, 1.0),
        "lm_head": (model.lm_head, 1 / np.sqrt(512)),
    }
    for name, (leaf, scale) in want.items():
        std = float(leaf.std())
        # at least 131,072 draws a leaf: the std's own spread is under 0.4 %
        assert abs(std / scale - 1) < 0.02, (name, std, scale)
        assert abs(float(leaf.mean())) < 0.02 * scale, name
    assert torch.equal(block["ln1"]["w"], torch.ones(512))
    assert model.param_axes["layers.0.attn.wq"] == ("layers", "embed", "heads", "head_dim")
    assert model.param_axes["embed"] == ("vocab", "embed")
    assert not any(p.requires_grad for p in model.parameters())
    again = lm.init_lm(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# --- attention -------------------------------------------------------------------

FLASH_CASES = {
    # (b, sq, sk, kv, r, dh, causal, window, q_offset, block_q, block_kv, skip)
    "blocks": (2, 16, 16, 2, 2, 8, True, None, 0, 8, 8, False),
    "padded": (2, 20, 20, 2, 2, 8, True, None, 0, 8, 8, False),
    "padded_kv_longer": (1, 8, 27, 1, 3, 8, True, None, 19, 8, 8, False),
    "non_causal_padded": (2, 13, 21, 2, 2, 8, False, None, 0, 8, 8, False),
    "window": (2, 24, 24, 2, 2, 8, True, 5, 0, 8, 8, False),
    "skip": (2, 32, 32, 2, 2, 8, True, None, 0, 8, 8, True),
    "skip_padded": (1, 20, 20, 1, 4, 16, True, None, 0, 8, 4, True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention(case):
    b, sq, sk, kv, r, dh, causal, window, q_off, bq, bk, skip = FLASH_CASES[case]
    q, k, v = _normal(10, (b, sq, kv, r, dh)), _normal(11, (b, sk, kv, dh)), _normal(
        12, (b, sk, kv, dh))
    kw = dict(causal=causal, window=window, q_offset=q_off, block_q=bq, block_kv=bk,
              unroll_causal_skip=skip)
    ref = jattn.flash_attention(q, k, v, **kw)
    out = attn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    # measured: 4.8e-7 at most over the cases (outputs up to 2.4)
    _assert_close(ref, out, 1e-6, case)


def test_decode_attention_per_row_index():
    b, smax, kv, r, dh = 4, 12, 2, 2, 8
    q, kc, vc = _normal(20, (b, 1, kv, r, dh)), _normal(21, (b, smax, kv, dh)), _normal(
        22, (b, smax, kv, dh))
    idx = np.array([1, 7, 12, 15], np.int32)  # the last past Smax: every entry valid
    for window in (None, 4):
        ref = jattn.decode_attention(q, kc, vc, index=jnp.asarray(idx), window=window)
        out = attn.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                                    index=torch.from_numpy(idx), window=window)
        # measured: 2.4e-7 (outputs up to 2.6)
        _assert_close(ref, out, 1e-6, f"window {window}")
    ref = jattn.decode_attention(q, kc, vc, index=jnp.int32(9), window=None)
    out = attn.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                                index=torch.tensor(9, dtype=torch.int32), window=None)
    _assert_close(ref, out, 1e-6, "scalar index")


def _attn_cfg(**kw):
    base = dict(name="a", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, vocab_size=64, **COMMON)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_full_mode_fills_cache(qk_norm):
    jcfg, tcfg = _attn_cfg(qk_norm=qk_norm)
    p = jattn.init_attention(jax.random.PRNGKey(0), jcfg)
    tp = _params(p)
    x = _normal(30, (2, 11, 32))
    pos = np.arange(11, dtype=np.int32)
    jcache = jattn.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = attn.init_kv_cache(tcfg, 2, 16, dtype=torch.float32)
    ref, jnew = jattn.attention(jlayers.split_annotated(p)[0], x, jcfg, positions=pos,
                                mode="full", cache=jcache)
    out, tnew = attn.attention(tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                               mode="full", cache=tcache)
    # measured: out 2.0e-5 (outputs up to 31: wq's scale is 1/sqrt(4)),
    # cache 2.9e-6 (entries up to 16)
    _assert_close(ref, out, 5e-5, "out")
    for name in ("k", "v"):
        _assert_close(jnew[name], tnew[name], 5e-6, name)


def test_attention_decode_clamps_the_cache_write():
    """A per-row start past Smax - 1 writes the last row, as XLA's
    dynamic_update_slice clamps it; the mask takes the unclamped index."""
    jcfg, tcfg = _attn_cfg(sliding_window=0)
    p = jattn.init_attention(jax.random.PRNGKey(1), jcfg)
    tp = _params(p)
    smax = 6
    kc, vc = _normal(31, (4, smax, 2, 8)), _normal(32, (4, smax, 2, 8))
    idx = np.array([0, 3, 5, 9], np.int32)  # rows 2 and 3 write the last row
    x = _normal(33, (4, 1, 32))
    for window in (None, 3):
        ref, jnew = jattn.attention(
            jlayers.split_annotated(p)[0], x, jcfg, positions=jnp.asarray(idx)[:, None],
            mode="decode", cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            cache_index=jnp.asarray(idx), window=window)
        tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
        out, tnew = attn.attention(
            tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(idx)[:, None],
            mode="decode", cache=tcache, cache_index=torch.from_numpy(idx), window=window)
        # measured: out 3.8e-6 (outputs up to 38), cache 1.9e-6
        _assert_close(ref, out, 1e-5, "out")
        for name in ("k", "v"):
            _assert_close(jnew[name], tnew[name], 5e-6, name)
        assert tnew["k"] is tcache["k"]  # written in place
        # rows 0 and 1 wrote at their index, rows 2 and 3 at Smax - 1
        assert not np.array_equal(tnew["k"][3, smax - 1].numpy(), kc[3, smax - 1])
        np.testing.assert_array_equal(tnew["k"][3, :smax - 1].numpy(), kc[3, :smax - 1])


def test_attention_decode_scalar_index():
    jcfg, tcfg = _attn_cfg()
    p = jattn.init_attention(jax.random.PRNGKey(2), jcfg)
    kc, vc = _normal(34, (2, 8, 2, 8)), _normal(35, (2, 8, 2, 8))
    x = _normal(36, (2, 1, 32))
    ref, jnew = jattn.attention(
        jlayers.split_annotated(p)[0], x, jcfg, positions=jnp.asarray([5]), mode="decode",
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, cache_index=jnp.int32(5))
    out, tnew = attn.attention(
        _params(p), torch.from_numpy(x), tcfg, positions=torch.tensor([5]), mode="decode",
        cache={"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())},
        cache_index=torch.tensor(5, dtype=torch.int32))
    # measured: out 8.3e-7, cache 9.5e-7
    _assert_close(ref, out, 2e-6, "out")
    _assert_close(jnew["k"], tnew["k"], 2e-6, "k")


def test_update_rows_clamps_like_dynamic_update_slice():
    buf = np.zeros((3, 5, 2), np.float32)
    upd = _normal(37, (3, 2, 2))
    for start in (np.array([0, 3, 7], np.int32), np.int32(4), np.array([9, 1, 4], np.int32)):
        if np.ndim(start):
            ref = jax.vmap(lambda c, u, i: jax.lax.dynamic_update_slice(c, u, (i, 0)))(
                buf, upd, start)
        else:
            ref = jax.lax.dynamic_update_slice(buf, upd, (0, start, 0))
        out = torch.from_numpy(buf.copy())
        attn.update_rows(out, torch.from_numpy(upd), torch.as_tensor(start))
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("kind,rows", [("int", 14), ("scalar", 14), ("per_row", 12)])
def test_update_rows_refuses_an_update_past_the_buffer(kind, rows):
    """An update longer than the buffer's sequence axis: JAX's
    dynamic_update_slice raises, so the port raises too (a start clamped
    to Smax - s would be negative and wrap) and writes nothing."""
    buf = np.zeros((2, 10, 3), np.float32)
    upd = _normal(38, (2, rows, 3))
    start = {"int": 0, "scalar": np.int32(0), "per_row": np.array([0, 3], np.int32)}[kind]
    with pytest.raises(TypeError):
        if kind == "per_row":
            jax.vmap(lambda c, u, i: jax.lax.dynamic_update_slice(c, u, (i, 0)))(buf, upd, start)
        else:
            jax.lax.dynamic_update_slice(buf, upd, (0, start, 0))
    out = torch.from_numpy(buf.copy())
    arg = start if kind == "int" else torch.as_tensor(start)
    with pytest.raises(ValueError, match=rf"\(2, {rows}, 3\).*\(2, 10, 3\)"):
        attn.update_rows(out, torch.from_numpy(upd), arg)
    assert not out.any()


def test_encoder_attention():
    """The audio encoder's self-attention: bidirectional, no RoPE, no
    cache, 13 keys padded to two blocks of 8 and masked."""
    jcfg, tcfg = _attn_cfg()
    p = jattn.init_attention(jax.random.PRNGKey(3), jcfg)
    x = _normal(40, (2, 13, 32))
    pos = np.arange(13, dtype=np.int32)
    kw = dict(mode="full", causal=False, use_rope=False)
    ref, jc = jattn.attention(jlayers.split_annotated(p)[0], x, jcfg, positions=pos, **kw)
    out, tc = attn.attention(_params(p), torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos), **kw)
    assert jc is None and tc is None
    # measured: 1.1e-5 (outputs up to 31)
    _assert_close(ref, out, 5e-5, "encoder attention")


def test_cross_attention_full_and_decode():
    """Whisper's cross-attention: in full mode K/V come from the encoder's
    output (11 keys, padded to two blocks of 8 and masked), are written
    into the cross cache in place and attended without a causal mask;
    a decode step reads all of that cache and writes nothing."""
    jcfg, tcfg = _attn_cfg()
    p = jattn.init_attention(jax.random.PRNGKey(4), jcfg)
    vals, tp = jlayers.split_annotated(p)[0], _params(p)
    x, enc = _normal(41, (2, 5, 32)), _normal(42, (2, 11, 32))
    kw = dict(causal=False, use_rope=False, cross=True)
    jcache = {"k": jnp.zeros((2, 11, 2, 8)), "v": jnp.zeros((2, 11, 2, 8))}
    tcache = {"k": torch.zeros((2, 11, 2, 8)), "v": torch.zeros((2, 11, 2, 8))}
    ref, jnew = jattn.attention(vals, x, jcfg, positions=np.arange(5), mode="full",
                                cache=jcache, kv_input=enc, **kw)
    out, tnew = attn.attention(tp, torch.from_numpy(x), tcfg, positions=torch.arange(5),
                               mode="full", cache=tcache, kv_input=torch.from_numpy(enc), **kw)
    # measured: out 1.0e-5 (outputs up to 29), cache 2.9e-6 (entries up to 12)
    _assert_close(ref, out, 5e-5, "cross full")
    for name in ("k", "v"):
        _assert_close(jnew[name], tnew[name], 1e-5, f"cross cache {name}")
        assert tnew[name] is tcache[name]  # written in place
    stored = {k: v.clone() for k, v in tnew.items()}
    xd = _normal(43, (2, 1, 32))
    idx = np.array([5, 2], np.int32)  # the decoder's positions play no part
    ref, jd = jattn.attention(vals, xd, jcfg, positions=idx[:, None], mode="decode",
                              cache=jnew, **kw)
    out, td = attn.attention(tp, torch.from_numpy(xd), tcfg,
                             positions=torch.from_numpy(idx)[:, None], mode="decode",
                             cache=tnew, **kw)
    # measured: 2.2e-5 (outputs up to 18)
    _assert_close(ref, out, 5e-5, "cross decode")
    assert all(torch.equal(td[k], stored[k]) for k in stored)


@pytest.mark.parametrize("kind", blocks.KINDS)
def test_every_block_kind_builds(kind):
    """Every kind of the JAX package's blocks builds, with the JAX tree's
    leaf names; an unknown kind raises."""
    arch = {"moe": "qwen3_moe_30b", "ssm": "mamba2_1p3b", "hybrid": "hymba_1p5b"}.get(
        kind, "whisper_large_v3")
    cfg = configs.get_smoke_config(arch)
    block = blocks.init_block(torch.Generator().manual_seed(0), cfg, kind=kind)
    names = {n.split(".")[0] for n, _ in block.named_parameters()}
    want = {"ln1"} | {"ssm": {"mamba"}, "hybrid": {"attn", "mamba", "branch_scale", "ln2", "mlp"},
                      "moe": {"attn", "ln2", "moe"},
                      "encoder_cross": {"attn", "ln_cross", "cross", "ln2", "mlp"}}.get(
        kind, {"attn", "ln2", "mlp"})
    assert names == want
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.init_block(None, cfg, kind="decoder")


# --- the language model ----------------------------------------------------------


def _carried(jcfg, tcfg, seed):
    values, _ = jlm.init_lm_values(jax.random.PRNGKey(seed), jcfg)
    return values, convert.lm_from_numpy(jax.tree.map(np.asarray, values), tcfg, device="cpu")


@pytest.mark.parametrize("which", ["granite3_8b_smoke", "per_row_config"])
def test_init_cache(which):
    if which == "per_row_config":
        jcfg, tcfg = JModelConfig(**PER_ROW), ModelConfig(**PER_ROW)
    else:
        jcfg, tcfg = jconfigs.get_smoke_config("granite3_8b"), configs.get_smoke_config(
            "granite3_8b")
    jc = jlm.init_cache(jcfg, 3, 10)
    tc = lm.init_cache(tcfg, 3, 10, device="cpu")
    assert tc["index"].dtype == torch.int32 and tc["index"].shape == ()
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        assert str(tc["layers"][name].dtype) == f"torch.{jc['layers'][name].dtype.name}"
        assert not tc["layers"][name].any()


# every ported architecture's smoke config (ROADMAP.md queue 3 item 4)
PORTED_ARCHS = ("granite3_8b", "granite_34b", "minitron_4b", "phi3_medium_14b", "qwen3_moe_30b",
                "phi35_moe_42b", "mamba2_1p3b", "hymba_1p5b", "phi3_vision_4p2b",
                "whisper_large_v3")


def _extras(cfg, row: int) -> dict:
    """The frontend stubs' inputs of one batch row, from a seed: the VLM's
    patch embeddings and the audio family's mel frames (numpy)."""
    rng = np.random.default_rng(90 + row)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = rng.standard_normal(
            (1, cfg.n_image_tokens, cfg.image_embed_dim)).astype(np.float32)
    if cfg.is_encdec:
        extras["frames"] = rng.standard_normal((1, cfg.encoder_len, cfg.frame_dim)).astype(
            np.float32)
    return extras


def _prefill_pair(values, model, jcfg, tcfg, tokens, row, jcache, tcache):
    """One row's prefill on both sides, with the row's frontend inputs."""
    extras = _extras(jcfg, row)
    jout = jlm.prefill(values, jcfg, {"tokens": tokens, **extras}, jcache)
    tout = lm.prefill(model, tcfg, {"tokens": torch.from_numpy(tokens),
                                    **{k: torch.from_numpy(v) for k, v in extras.items()}},
                      tcache)
    return jout, tout


def _flat(tree, prefix=""):
    """A cache tree's leaves by path, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("which", [f"{a}_smoke" for a in PORTED_ARCHS] + ["per_row_config"])
def test_prefill_and_decode_match_jax(which):
    """Prefill then 3 decode steps per row (scalar index), and the packed
    batch (per-row index), against the JAX functions on carried weights.
    The packed cache is spliced leaf by leaf, as ``launch/serve.py`` does
    (a KV cache, an SSM state, or the hybrid's or whisper's nested pair).
    The VLM's prompts follow its image tokens, so its cache holds them
    too; whisper's rows cross-attend to their own encoded frames."""
    if which == "per_row_config":
        jcfg, tcfg = JModelConfig(**PER_ROW), ModelConfig(**PER_ROW)
        lens, max_len = (5, 9), 20
    else:
        arch = which.removesuffix("_smoke")
        jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
        # row 1 prefills past two attention blocks, past hymba's window of
        # 8 and past the SSM chunk of 8 (11 = one chunk and a padded one)
        lens, max_len = (5, 11), 16 + jcfg.n_image_tokens
    values, model = _carried(jcfg, tcfg, 3)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    # measured |logit difference| (logits up to 4.2): granite-3 1.2e-5,
    # granite-34b 1.2e-4 (row 1's last step: its MQA attention, nearly
    # one-hot under the init rule, magnifies its scores' rounding),
    # minitron 6.5e-6, phi-3-medium 9.8e-6, qwen3-moe 1.7e-6, phi-3.5-moe
    # 7.5e-6, mamba2 2.1e-6, hymba 1.0e-5, phi-3-vision 6.7e-6, whisper
    # 1.9e-4 (a bidirectional encoder and layer norms before every
    # decoder attention), the per-row config 7.9e-6.  Caches: KV and conv
    # inputs 8.7e-5 at most (entries up to 27; whisper's self and cross
    # K/V 1.2e-4), SSM states 2.1e-4 (hymba; entries up to 255)
    tol = {"granite_34b_smoke": 2e-4, "whisper_large_v3_smoke": 5e-4}.get(which, 5e-5)
    cache_tol = {"state": 5e-4}
    leaf_tol = 3e-4 if which == "whisper_large_v3_smoke" else 1e-4
    for r, plen in enumerate(lens):
        jc, tc = jlm.init_cache(jcfg, 1, max_len), lm.init_cache(tcfg, 1, max_len, "cpu")
        (jl, jc), (tl, tc) = _prefill_pair(values, model, jcfg, tcfg, toks[r:r + 1, :plen], r,
                                           jc, tc)
        _assert_close(jl, tl, tol, f"row {r} prefill")
        for t in range(3):
            step = toks[r:r + 1, plen + t:plen + t + 1]
            jl, jc = jlm.decode_step(values, jcfg, step, jc)
            tl, tc = lm.decode_step(model, tcfg, torch.from_numpy(step), tc)
            _assert_close(jl, tl, tol, f"row {r} step {t}")
        assert int(tc["index"]) == int(jc["index"]) == jcfg.n_image_tokens + plen + 3
        jleaves, tleaves = _flat(jc["layers"]), _flat(tc["layers"])
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (path, a), (_, b) in zip(jleaves, tleaves):
            _assert_close(a, b, cache_tol.get(path.rsplit("/", 1)[-1], leaf_tol), f"cache {path}")

    # packed: per-row prefills spliced into one cache with a (B,) index
    jshared, tshared = jlm.init_cache(jcfg, 2, max_len), lm.init_cache(tcfg, 2, max_len, "cpu")
    jshared["index"] = jnp.zeros((2,), jnp.int32)
    tshared["index"] = torch.zeros((2,), dtype=torch.int32)
    for r, plen in enumerate(lens):
        (_, jrow), (_, trow) = _prefill_pair(values, model, jcfg, tcfg, toks[r:r + 1, :plen], r,
                                             jlm.init_cache(jcfg, 1, max_len),
                                             lm.init_cache(tcfg, 1, max_len, "cpu"))
        jshared["layers"] = jax.tree.map(lambda s, x: s.at[:, r:r + 1].set(x),
                                         jshared["layers"], jrow["layers"])
        jshared["index"] = jshared["index"].at[r].set(jrow["index"])

        def splice(shared, row):
            shared[:, r:r + 1] = row

        lm.tree_map(splice, tshared["layers"], trow["layers"])
        tshared["index"][r] = trow["index"]
    for t in range(3):
        step = np.stack([toks[r, lens[r] + t] for r in range(2)])[:, None]
        jl, jshared = jlm.decode_step(values, jcfg, step, jshared)
        tl, tshared = lm.decode_step(model, tcfg, torch.from_numpy(step), tshared)
        _assert_close(jl, tl, tol, f"packed step {t}")
    np.testing.assert_array_equal(np.asarray(jshared["index"]), tshared["index"].numpy())


def test_heterogeneous_decode_matches_scalar_index():
    """tests/test_models.py:TestPerRowCacheIndex on the port alone: slots
    at different positions reproduce the scalar-index solo decode."""
    cfg = ModelConfig(**PER_ROW)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 100, (2, 16)).astype(np.int32))
    lens, max_len = (5, 9), 20
    refs = {0: [], 1: []}
    for r, plen in enumerate(lens):
        cache = lm.init_cache(cfg, 1, max_len, "cpu")
        _, cache = lm.prefill(model, cfg, {"tokens": tokens[r:r + 1, :plen]}, cache)
        for t in range(3):
            logits, cache = lm.decode_step(model, cfg, tokens[r:r + 1, plen + t:plen + t + 1],
                                           cache)
            refs[r].append(logits[0])
    shared = lm.init_cache(cfg, 2, max_len, "cpu")
    shared["index"] = torch.zeros((2,), dtype=torch.int32)
    for r, plen in enumerate(lens):
        _, row = lm.prefill(model, cfg, {"tokens": tokens[r:r + 1, :plen]},
                            lm.init_cache(cfg, 1, max_len, "cpu"))
        for name in ("k", "v"):
            shared["layers"][name][:, r:r + 1] = row["layers"][name]
        shared["index"][r] = row["index"]
    for t in range(3):
        step = torch.stack([tokens[r, lens[r] + t] for r in range(2)])[:, None]
        logits, shared = lm.decode_step(model, cfg, step, shared)
        for r in range(2):
            np.testing.assert_allclose(logits[r].numpy(), refs[r][t].numpy(), atol=2e-4,
                                       err_msg=f"row {r} step {t}")


def test_vocab_padding_masked():
    cfg = ModelConfig(**{**PER_ROW, "d_model": 32})
    assert cfg.padded_vocab == 256
    model = lm.init_lm(cfg, seed=6, device="cpu")
    logits = lm.head_logits(model, cfg, torch.randn(1, 4, 32))
    assert logits.shape[-1] == 256 and logits.dtype == torch.float32
    assert float(logits[..., 100:].max()) <= -1e29


def test_converter_round_trip():
    jcfg, tcfg = jconfigs.get_smoke_config("granite3_8b"), configs.get_smoke_config(
        "granite3_8b")
    values, model = _carried(jcfg, tcfg, 4)
    back = convert.lm_to_numpy(model)
    flat_j = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    again = convert.lm_from_numpy(back, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    # a bfloat16 model widens to float32 and narrows back exactly
    bf = dataclasses.replace(tcfg, param_dtype_str="bfloat16")
    m_bf = lm.init_lm(bf, seed=1, device="cpu")
    m_back = convert.lm_from_numpy(convert.lm_to_numpy(m_bf), bf, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m_bf.parameters(), m_back.parameters()))
    # a bfloat16 numpy leaf (the JAX package's param dtype) crosses by its bits
    jbf = dataclasses.replace(jcfg, param_dtype_str="bfloat16")
    vbf, _ = jlm.init_lm_values(jax.random.PRNGKey(4), jbf)
    m_jbf = convert.lm_from_numpy(jax.tree.map(np.asarray, vbf), bf, device="cpu")
    np.testing.assert_array_equal(np.asarray(vbf["lm_head"]).astype(np.float32),
                                  m_jbf.lm_head.float().numpy())
    bad = dict(values, extra=np.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        convert.lm_from_numpy(jax.tree.map(np.asarray, bad), tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3_moe_30b", "mamba2_1p3b", "hymba_1p5b", "phi3_vision_4p2b",
                                  "whisper_large_v3"])
def test_converter_carries_family_leaves(arch):
    """The ``moe``, ``mamba`` and ``branch_scale`` leaves cross at their own
    dtypes: a bfloat16 JAX tree keeps the router, ``A_log``, ``D``,
    ``dt_bias`` and ``branch_scale`` in float32, bit for bit, both ways.
    The VLM's ``img_proj`` and the audio family's ``audio_proj``,
    ``enc_pos``, stacked ``encoder`` and ``enc_norm`` and each decoder
    layer's ``ln_cross`` and ``cross`` cross in the JAX tree's order."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), param_dtype_str="bfloat16")
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), param_dtype_str="bfloat16")
    # jitted: the eager init compiles op by op, several times slower here
    values = jax.jit(lambda k: jlm.init_lm_values(k, jcfg)[0])(jax.random.PRNGKey(5))
    values = jax.tree.map(np.asarray, values)
    model = convert.lm_from_numpy(values, tcfg, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(values)[0])
    float32 = {"router", "A_log", "D", "dt_bias", "branch_scale"}
    seen = set()
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        want = torch.float32 if leaf in float32 else torch.bfloat16
        assert p.dtype == want, (name, p.dtype)
        seen.add(leaf)
    assert seen & float32 == float32 & {
        "qwen3_moe_30b": {"router"}, "mamba2_1p3b": {"A_log", "D", "dt_bias"},
        "hymba_1p5b": {"A_log", "D", "dt_bias", "branch_scale"}}.get(arch, set())
    top = {"phi3_vision_4p2b": {"img_proj"},
           "whisper_large_v3": {"audio_proj", "enc_pos", "encoder", "enc_norm"}}.get(arch, set())
    assert top <= set(values)
    if arch == "whisper_large_v3":
        assert {"ln_cross", "cross"} <= set(values["layers"])
        assert np.shape(values["encoder"]["attn"]["wq"])[0] == jcfg.n_encoder_layers
    back = convert.lm_to_numpy(model)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert list(flat) == list(flat_back)
    for path, a in flat.items():
        np.testing.assert_array_equal(a.astype(np.float32), flat_back[path], err_msg=str(path))


def test_init_lm_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_lm(configs.get_smoke_config("granite3_8b"))
