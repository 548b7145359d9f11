"""The port's sharding rules (``repro_torch.distributed.sharding``) and
``attention._gqa_layout`` against the JAX package's, on meshes without
devices: the port's ``AbstractMesh`` beside ``jax.sharding.AbstractMesh``
of the same shape.  Every case of ``tests/test_sharding.py`` runs through
both packages and must give the same spec (tolerance 0: specs are
names); the per-leaf specs of a full-width model's parameters likewise.
"""

import jax
import pytest

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.distributed import sharding as tsh
from repro_torch.models import attention
from repro_torch.models import lm

if not hasattr(jax.sharding, "AxisType"):
    pytest.skip("jax.sharding.AxisType unavailable on this jax version", allow_module_level=True)
from jax.sharding import AxisType  # noqa: E402

SHAPES = {"MESH": ((16, 16), ("data", "model")), "MESH3": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name, manual=()):
    """(the JAX AbstractMesh, the port's) of a named shape; ``manual`` names
    the dimensions a JAX shard_map would make Manual."""
    sizes, names = SHAPES[name]
    types = tuple(AxisType.Manual if n in manual else AxisType.Auto for n in names)
    return jax.sharding.AbstractMesh(sizes, names, axis_types=types), tsh.AbstractMesh(sizes, names)


def _spec(p):
    return None if p is None else tuple(p)


CACHE_RULES = {"cache_seq": ("pod", "data", "model")}

# tests/test_sharding.py, case by case: (mesh, logical axes, shape, rule patch)
SPEC_CASES = {
    "batch_over_pod_data": ("MESH3", ("batch", "seq"), (256, 4096), {}),
    "divisibility_fallback": ("MESH", ("embed", "heads", "head_dim"), (1600, 25, 64), {}),
    "divisible_heads_shard": ("MESH", ("embed", "heads", "head_dim"), (4096, 32, 128), {}),
    "partial_compound_axis": ("MESH3", ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                              (32, 1, 524288, 5, 64), CACHE_RULES),
    "used_axis_skipped_not_dropped": ("MESH3", ("layers", "batch", "cache_seq", "kv_heads",
                                                "head_dim"), (88, 128, 32768, 1, 128),
                                      CACHE_RULES),
    "vocab_sharding": ("MESH", ("embed", "vocab"), (4096, 49408), {}),
    "odd_vocab_raw": ("MESH", ("vocab",), (49155,), {}),
    "odd_vocab_padded": ("MESH", ("vocab",), (49408,), {}),
    "no_shape": ("MESH3", ("batch", "heads", "embed_tp"), None, {}),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_for_matches_jax(case):
    mesh, axes, shape, patch = SPEC_CASES[case]
    jmesh, tmesh = _meshes(mesh)
    want = jsh.spec_for(axes, jsh.ShardingRules().replace(**patch), shape=shape, mesh=jmesh)
    got = tsh.spec_for(axes, tsh.ShardingRules().replace(**patch), shape=shape, mesh=tmesh)
    assert got == _spec(want)


def test_no_mesh_returns_none():
    assert jsh.spec_for(("batch",), shape=(8,), mesh=None) is None
    assert tsh.spec_for(("batch",), shape=(8,), mesh=None) is None


def test_spec_for_skips_manual_axes():
    """Inside a region manual over "pod" the rules skip it, as JAX skips
    a Manual axis of the abstract mesh."""
    jmesh, tmesh = _meshes("MESH3", manual=("pod",))
    want = jsh.spec_for(("batch", "seq", "vocab"), shape=(256, 16, 49408), mesh=jmesh)
    with tsh.manual_axes({"pod"}):
        got = tsh.spec_for(("batch", "seq", "vocab"), shape=(256, 16, 49408), mesh=tmesh)
    assert got == _spec(want) == ("data", None, "model")
    assert tsh.spec_for(("batch",), shape=(256,), mesh=tmesh) == (("pod", "data"),)


# tests/test_sharding.py's TestZeroAxes: (mesh, logical axes, shape)
ZERO_CASES = {
    "extends_replicated_dim": ("MESH", ("embed", "heads", "head_dim"), (4096, 32, 128)),
    "skips_indivisible": ("MESH", ("heads",), (25,)),
    "on_3d_mesh": ("MESH3", ("embed", "ffn"), (4096, 12800)),
    "first_divisible_dim": ("MESH3", ("layers", "embed", "ffn"), (31, 4096, 12800)),
}


@pytest.mark.parametrize("case", list(ZERO_CASES))
def test_zero_axes_match_jax(case):
    mesh, axes, shape = ZERO_CASES[case]
    jmesh, tmesh = _meshes(mesh)
    want = jsh.add_zero_axes(axes, shape, mesh=jmesh)
    got = tsh.add_zero_axes(axes, shape, mesh=tmesh)
    assert got == tuple(want)
    assert tsh.spec_for(got, tsh.rules_with_zero(), shape=shape, mesh=tmesh) == _spec(
        jsh.spec_for(want, jsh.rules_with_zero(), shape=shape, mesh=jmesh))
    assert tsh.ZERO_RULES_PATCH == jsh.ZERO_RULES_PATCH


def test_rules_tables_match_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.ShardingRules().as_dict()["cache_seq"] is None  # unpolluted
    for arch in jconfigs.ARCH_IDS:
        assert tsh.rules_for_config(configs.get_config(arch)).as_dict() == jsh.rules_for_config(
            jconfigs.get_config(arch)).as_dict(), arch
    with tsh.use_rules(tsh.ShardingRules().replace(seq="data")):
        assert tsh.get_rules().as_dict()["seq"] == "data"
    assert tsh.get_rules() == tsh.ShardingRules()


@pytest.mark.parametrize("arch", ["granite3_8b", "qwen3_moe_30b", "hymba_1p5b", "whisper_large_v3"])
def test_tree_specs_match_jax(arch):
    """Every parameter leaf's spec at full width on the multi-pod mesh:
    the port's leaf is one layer of JAX's stacked leaf, whose spec leads
    with the replicated "layers" entry."""
    jmesh, tmesh = _meshes("MESH3")
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    shapes, axes = jlm.abstract_params(jcfg)
    want = jsh.tree_specs(axes, jsh.rules_for_config(jcfg), shapes, mesh=jmesh)
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    model = lm.LM(tcfg, device="meta")
    got = tsh.tree_specs(model.param_axes, tsh.rules_for_config(tcfg),
                         dict(model.named_parameters()), mesh=tmesh)
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        stacked = parts[0] in lm.STACKS
        key = "".join(f"['{p}']" for p in (parts[:1] + parts[2:] if stacked else parts))
        seen.add(key)
        jspec = _spec(flat[key])
        if stacked and jspec:
            assert jspec[0] is None, key
            jspec = jspec[1:]
        assert spec == jspec, (name, spec, jspec)
    assert seen == set(flat)


# the three GQA layouts: (kv heads, group size, mesh sizes, names)
GQA_CASES = {
    "no_mesh": (8, 4, None),
    "A_kv_divides_model": (8, 4, ((2, 4), ("data", "model"))),
    "B_heads_divide_model": (2, 4, ((2, 4), ("data", "model"))),
    "C_neither_divides": (2, 4, ((1, 3), ("data", "model"))),
    "model_of_one": (5, 1, ((4, 1), ("data", "model"))),
    "no_model_axis": (5, 2, ((4,), ("data",))),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_layout_matches_jax(case):
    kv, r, mesh = GQA_CASES[case]
    if mesh is None:
        assert attention._gqa_layout(kv, r) == jattention._gqa_layout(kv, r) == (kv, r, False)
        return
    sizes, names = mesh
    jmesh = jax.sharding.AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(names))
    with jax.sharding.use_abstract_mesh(jmesh):
        want = jattention._gqa_layout(kv, r)
    with tsh.use_mesh(tsh.AbstractMesh(sizes, names)):
        got = attention._gqa_layout(kv, r)
    assert got == tuple(want)
    expect = {"A_kv_divides_model": (8, 4, False), "B_heads_divide_model": (8, 1, True),
              "C_neither_divides": (2, 4, False)}
    assert got == expect.get(case, (kv, r, False))


def test_named_sharding_placements():
    """A spec as placements per mesh dimension: a compound entry splits
    its tensor dimension over each of its mesh dimensions in mesh order;
    a dimension of one element stays whole; another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.named_sharding(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.named_sharding(mesh, ()) == [Replicate()] * 3
    assert tsh.named_sharding(mesh, (None, "model"), shape=(4, 1)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.named_sharding(mesh, (("data", "pod"),))


def test_shard_is_the_identity_without_a_device_mesh():
    import torch

    x = torch.arange(12.0).reshape(3, 4)
    assert tsh.shard(x, ("batch", "embed")) is x
    with tsh.use_mesh(tsh.AbstractMesh((2,), ("data",))):
        assert tsh.active_mesh() == tsh.AbstractMesh((2,), ("data",))
        assert tsh.shard(x, ("batch", "embed")) is x
    assert tsh.active_mesh() is None
