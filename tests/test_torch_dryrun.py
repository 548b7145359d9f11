"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
JAX package's ``lower_cell``, and the repairs it needed.

One JAX subprocess, started by a module fixture, lowers the smoke
granite3_8b and qwen3_moe_30b configs on ``alt_mesh(1, 1)`` and
``alt_mesh(2, 2)`` for the train, prefill and decode kinds, and the
decode-sample step on (1, 1), and writes JAX's reports.  It must set its
own device count before JAX starts (``repro.launch.dryrun`` asks for 512
host devices at import, and the test process pins one), so it runs as
``python tests/test_torch_dryrun.py OUT``.  The port traces the same
cells here, on 1- and 4-rank fake process groups with ``device="cpu"``,
while the subprocess runs.

Held: the parameter counts exactly; the argument bytes exactly, apart
from the batch and the sampler's key, whose dtypes differ (the port's
tokens are int64, its key two int64 words) and which the port hands
every rank whole: their bytes are computed on both sides and taken out;
the FLOPs exactly on (1, 1) and (2, 2) for every kind (both sides count
matrix products only, and JAX's default remat and the port's checkpoint
both recompute): on (2, 2) the port's plan is JAX's, the MLP on its
``d_ff`` shard and the decode scores on each rank's heads or cache rows.
No (2, 2) cell all-gathers the embedding table or an MLP weight (the
collectives' operands are read: the parameter each is made from, and
its shape).  The (2, 2) collective bytes are held to JAX's plan: a
prefill or decode cell moves at most 1.25 times JAX's bytes (phase 37's
bound on the card) and has no reduce-scatter, as JAX's has none; a
train cell moves at most 1.45 times JAX's; no cell all-gathers a local
shard of the logits (the loss is vocab-parallel) or of the experts'
outputs (the MoE combine reduces contributions).  Temp bytes are
recorded side by side in PERF.md, not held.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite3_8b", "qwen3_moe_30b")
MESHES = ("1x1", "2x2")
N_MICRO = 2
SHAPES = {  # name: (seq_len, global_batch, kind), registered on both sides
    "dry_train": (32, 8, "train"),  # two logits chunks: both sides recompute them
    "dry_prefill": (16, 4, "prefill"),
    "dry_decode": (32, 4, "decode"),
    "dry_pod": (16, 4, "train"),  # the compressed cell's, the port's only
}
CELLS = [(arch, mesh, shape, False) for mesh in MESHES for arch in ARCHS
         for shape in ("dry_train", "dry_prefill", "dry_decode")]
CELLS += [(arch, "1x1", "dry_decode", True) for arch in ARCHS]

def _register_shapes(cfgs_mod):
    for name, (seq, batch, kind) in SHAPES.items():
        cfgs_mod.SHAPES[name] = cfgs_mod.ShapeSpec(name, seq, batch, kind)


def _smoke(cfgs_mod, arch):
    return dataclasses.replace(cfgs_mod.get_smoke_config(arch), train_microbatches=N_MICRO)


def _key(arch, mesh, shape, sample):
    return f"{arch}|{mesh}|{shape}|{int(sample)}"


def _jax_reports(out: str) -> None:
    """The JAX side, in its own process: ``lower_cell`` on every cell."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    import jax

    jax.devices()  # the backend starts with 4 devices; the import below asks too late
    from repro import configs as jcfg
    from repro.launch import dryrun as jdry
    from repro.launch.mesh import alt_mesh

    jdry.ARTIFACT_DIR = os.path.join(out, "hlo")
    _register_shapes(jcfg)
    reports = {}
    for arch, mesh, shape, sample in CELLS:
        m = alt_mesh(*(int(x) for x in mesh.split("x")))
        r = jdry.run_cell(arch, shape, m, cfg=_smoke(jcfg, arch), decode_sample=sample)
        assert r["status"] == "ok", r
        r.pop("hlo_gz", None)
        reports[_key(arch, mesh, shape, sample)] = r
    with open(os.path.join(out, "jax.json"), "w") as f:
        json.dump(reports, f)


def _port_cells() -> dict:
    reports = {}
    for mesh_arg in MESHES:
        make, _, world = dryrun.mesh_for(mesh_arg, False, "cpu")
        with dryrun.fake_group(world):
            mesh = make()
            for arch, m, shape, sample in CELLS:
                if m == mesh_arg:
                    reports[_key(arch, m, shape, sample)] = dryrun.run_cell(
                        arch, shape, mesh, cfg=_smoke(configs, arch), device="cpu",
                        decode_sample=sample)
            del mesh
    return reports


@pytest.fixture(scope="module")
def reports():
    """(JAX's reports, the port's), by cell."""
    _register_shapes(configs)
    out = tempfile.mkdtemp(prefix="torch_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, __file__, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = _port_cells()
    finally:
        _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    with open(os.path.join(out, "jax.json")) as f:
        return json.load(f), port


def _batch_bytes(cfgs_mod, cfg, shape, mesh: str, *, itemsize: int, split: bool) -> int:
    """Bytes of one cell's batch a device holds with token ``itemsize``:
    cut by the batch rule (JAX's batch sharding) or whole (the port's)."""
    n = int(mesh.split("x")[0]) if split else 1
    total = 0
    for name, t in cfgs_mod.batch_specs(cfg, cfgs_mod.SHAPES[shape]).items():
        size = itemsize if name in ("tokens", "labels") else t.element_size()
        total += t.numel() * size
    return total // n


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: _key(*c))
def test_dryrun_cell_holds_against_jax(reports, cell):
    jax_r, port_r = (r[_key(*cell)] for r in reports)
    arch, mesh, shape, sample = cell
    assert port_r["status"] == "ok", port_r
    for k in ("param_count", "param_count_active", "kind", "chips"):
        assert port_r[k] == jax_r[k], k
    assert port_r["mesh"] == jax_r["mesh"]

    # the arguments, exactly, once the batch (int32 tokens split over
    # "data" in JAX, int64 and whole here) and the key (JAX's 2 uint32
    # words, the port's 2 int64) are taken out on both sides
    cfg = _smoke(configs, arch)
    key_bytes = (8, 16) if sample else (0, 0)
    jax_rest = (jax_r["memory_analysis"]["argument_size_bytes"] - key_bytes[0]
                - _batch_bytes(configs, cfg, shape, mesh, itemsize=4, split=True))
    port_rest = (port_r["memory_analysis"]["argument_size_bytes"] - key_bytes[1]
                 - _batch_bytes(configs, cfg, shape, mesh, itemsize=8, split=False))
    assert port_r["argument_bytes"]["batch"] == _batch_bytes(configs, cfg, shape, mesh,
                                                             itemsize=8, split=False)
    assert port_rest == jax_rest

    jf, pf = jax_r["hlo_cost"]["flops"], port_r["hlo_cost"]["flops"]
    assert pf == jf, (pf, jf)
    assert port_r["hlo_cost"]["unknown_trip_loops"] == 0
    assert port_r["memory_analysis"]["generated_code_bytes"] == 0
    if mesh == "1x1":  # one rank: no collective on either side
        assert port_r["collectives"]["total"] == jax_r["collectives"]["total"] == 0


def _weight_shards(cfg, mesh: str) -> dict:
    """The local block each device holds of the embedding table and of
    every MLP weight, as ``distribute_params`` places them: {shape: name}."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm

    model, axes = lm.abstract_params(cfg)
    amesh = sharding.AbstractMesh(tuple(int(x) for x in mesh.split("x")), ("data", "model"))
    rules = sharding.rules_for_config(cfg)
    out = {}
    for name, p in model.named_parameters():
        if name != "embed" and ".mlp." not in name:
            continue
        shape = list(p.shape)
        spec = sharding.spec_for(sharding.leaf_axes(axes[name], p.ndim), rules,
                                 shape=tuple(p.shape), mesh=amesh)
        for dim, entry in enumerate(spec or ()):
            for axis in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
                shape[dim] //= amesh.shape[axis]
        out[tuple(shape)] = name
    return out


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] == "2x2"], ids=lambda c: _key(*c))
def test_no_weight_is_all_gathered_on_2x2(reports, cell):
    """The port's plan on (2, 2) gathers no weight on the main path: no
    all-gather has as its operand the embedding table (the lookup is
    vocab-parallel) or an MLP weight (the MLP runs on its ``d_ff``
    shard), whether the operand is named after the parameter it was made
    from (its shard, or a view, cast or padded copy of it) or has the
    shape of its shard.  The ZeRO update's gathers of the updated
    weights, cut over "data" as the moments are, are the update's, as in
    JAX, and are made from more than the weight.  At these sizes a (64,
    64) operand may also be the MLP's hidden layer on its shard (64
    tokens), which JAX's plan does not gather either."""
    arch, mesh, _, _ = cell
    cfg = _smoke(configs, arch)
    shards = _weight_shards(cfg, mesh)
    assert any(name == "embed" for name in shards.values())
    ops = reports[1][_key(*cell)]["collective_ops"]
    assert ops and all(len(op) == 4 for op in ops)
    gathered = [(tuple(shape), weight) for kind, _, shape, weight in ops
                if kind == "all-gather" and (tuple(shape) in shards or weight == "embed"
                                             or ".mlp." in (weight or ""))]
    assert gathered == [], gathered


SERVE_MAX_COLLECTIVE_RATIO = 1.25  # chip_smoke.py's DRYRUN_MAX_COLLECTIVE_RATIO
TRAIN_MAX_COLLECTIVE_RATIO = 1.45


def _activation_shards(cfg, mesh: str, shape: str) -> dict:
    """The local block each device holds of the cell's logits chunk,
    (B_local, chunk, padded_vocab / model), and of a MoE layer's expert
    buffer, (B_local, E / model, cap, d): {shape: what}."""
    from repro_torch.models import moe

    data, model = (int(x) for x in mesh.split("x"))
    seq, batch, kind = SHAPES[shape]
    rows = batch // (N_MICRO if kind == "train" else 1) // data
    tokens = seq if kind != "decode" else 1
    chunk = min(cfg.logits_chunk, seq) if kind == "train" else 1
    while seq % chunk:
        chunk -= 1
    out = {(rows, chunk, cfg.padded_vocab // model): "logits"}
    if cfg.n_experts:
        cap = moe.capacity(tokens, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
        out[(rows, cfg.n_experts // model, cap, cfg.d_model)] = "experts"
    return out


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] == "2x2"], ids=lambda c: _key(*c))
def test_collectives_hold_against_jax_on_2x2(reports, cell):
    """The (2, 2) plan against JAX's: the collective bytes within the
    kind's ratio of JAX's; no reduce-scatter in a prefill or decode cell;
    no all-gather of a local shard of the logits or of the experts'
    outputs.  A train cell gathers the expert buffer's shape once a MoE
    layer a microbatch, in the backward pass: the dispatch buffer's
    gradient brought back to the dispatch's layout.  JAX's plan has as
    many (an all-gather to (2, 8, 16, 64) in its layer scan, run once a
    layer a microbatch)."""
    arch, mesh, shape, _ = cell
    jax_r, port_r = (r[_key(*cell)] for r in reports)
    cfg = _smoke(configs, arch)
    kind = SHAPES[shape][2]
    ratio = port_r["hlo_cost"]["collectives"]["total"] / jax_r["hlo_cost"]["collectives"]["total"]
    limit = TRAIN_MAX_COLLECTIVE_RATIO if kind == "train" else SERVE_MAX_COLLECTIVE_RATIO
    assert ratio <= limit, (ratio, limit)
    ops = port_r["collective_ops"]
    if kind != "train":
        assert not [op for op in ops if op[0] == "reduce-scatter"]
    shards = _activation_shards(cfg, mesh, shape)
    gathered = [shards[tuple(op[2])] for op in ops
                if op[0] == "all-gather" and tuple(op[2]) in shards]
    backward = N_MICRO * cfg.n_layers if kind == "train" and cfg.n_experts else 0
    assert sorted(gathered) == ["experts"] * backward, gathered


def test_compressed_cell_pod_bytes_equal_payload():
    """The compressed cross-pod cell on (pod 2, data 1, model 1): its
    all-reduce bytes are what ``compression.PAYLOAD`` counts for one
    ``compressed_pmean`` (int32 words and a float32 scale a leaf) plus the
    four float32 metrics the step averages over the pods."""
    from repro_torch.distributed import compression
    from repro_torch.models import lm

    _register_shapes(configs)
    make, tag, world = dryrun.mesh_for("1x1", True, "cpu")
    assert (tag, world) == ("pod2_1x1", 2)
    compression.PAYLOAD.clear()
    with dryrun.fake_group(world):
        mesh = make()
        r = dryrun.run_cell("granite3_8b", "dry_pod", mesh,
                            cfg=_smoke(configs, "granite3_8b"), device="cpu",
                            compress_pods=True)
        del mesh
    assert r["status"] == "ok", r
    payload = dict(compression.PAYLOAD)
    model, _ = lm.abstract_params(_smoke(configs, "granite3_8b"))
    n_params = sum(p.numel() for p in model.parameters())
    leaves = len(list(model.parameters()))
    assert payload == {"int32": 4 * n_params, "float32": 4 * leaves}
    assert r["collectives"]["all-reduce"] == sum(payload.values()) + 4 * 4
    assert r["argument_bytes"]["err"] == 4 * n_params


def test_production_mesh_on_the_cpu():
    """A smoke config on the (16, 16) production mesh: 256 fake ranks in
    this process, each device's share counted."""
    _register_shapes(configs)
    make, tag, world = dryrun.mesh_for(None, False, "cpu")
    assert (tag, world) == ("16x16", 256)
    with dryrun.fake_group(world):
        mesh = make()
        r = dryrun.run_cell("granite3_8b", "dry_decode", mesh,
                            cfg=configs.get_smoke_config("granite3_8b"), device="cpu")
        del mesh
    assert r["status"] == "ok", r
    assert (r["chips"], r["mesh"], r["mesh_axes"]) == (256, "16x16", ["data", "model"])
    assert r["hlo_cost"]["flops"] > 0 and r["max_rss_bytes"] > 0


def test_cli_reports_skipped_and_failed_cells(tmp_path, monkeypatch):
    """JAX's exit rule: a skipped cell is written and exits 0; a cell that
    raises is reported ``failed`` and the CLI exits 1."""
    argv = ["--arch", "granite3_8b", "--mesh", "1x1", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    reports = dryrun.main(argv + ["--shape", "long_500k"])
    assert [r["status"] for r in reports] == ["skipped"]
    assert json.loads((tmp_path / "1x1" / "granite-3-8b__long_500k.json").read_text())[
        "status"] == "skipped"

    def boom(*args, **kw):
        raise RuntimeError("no strategy")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv + ["--shape", "decode_32k", "--tag", "t"])
    assert exc.value.code == 1
    saved = json.loads((tmp_path / "1x1" / "granite-3-8b__decode_32k__t.json").read_text())
    assert saved["status"] == "failed" and "no strategy" in saved["error"]


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "granite3_8b", "--shape", "decode_32k"])


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_jax(arch):
    """``batch_specs`` / ``cache_specs`` / ``abstract_params`` at full size
    against the JAX package's: shapes alike, dtypes alike (int32 tokens
    int64 here), parameter bytes equal."""
    import jax

    from repro import configs as jcfg
    from repro.models import lm as jlm
    from repro_torch.models import lm

    cfg, jc = configs.get_config(arch), jcfg.get_config(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        got, want = (m.batch_specs(c, m.SHAPES[shape]) for m, c in ((configs, cfg), (jcfg, jc)))
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and got[k].device.type == "meta"
            wdt = "int64" if str(want[k].dtype) == "int32" else str(want[k].dtype)
            assert str(got[k].dtype) == f"torch.{wdt}"
        gc, wc = configs.cache_specs(cfg, configs.SHAPES[shape]), jcfg.cache_specs(
            jc, jcfg.SHAPES[shape])
        if wc is None:
            assert gc is None
            continue
        got_leaves = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                      for t in _flat(gc)]
        want_leaves = [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(wc)]
        assert sorted(got_leaves) == sorted(want_leaves)
    model, axes = lm.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert set(axes) == {n for n, _ in model.named_parameters()}
    shapes, _ = jlm.abstract_params(jc)
    assert sum(p.numel() * p.element_size() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) * s.dtype.itemsize for s in jax.tree.leaves(shapes))


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree


# --- the repairs --------------------------------------------------------------


def test_real_decode_after_dry_runs_is_unchanged():
    """Two dry runs (two fake tensor modes) in the process leave the RoPE
    table real, and a real smoke decode step gives the bits it gave
    before them."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.models import lm
    from repro_torch.models.layers import rope_frequencies

    _register_shapes(configs)
    cfg = configs.get_smoke_config("granite3_8b")
    model = lm.init_lm(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)))

    def decode():
        cache = lm.init_cache(cfg, 2, 16, "cpu")
        _, cache = lm.prefill(model, cfg, {"tokens": tokens[:, :8]}, cache)
        return lm.decode_step(model, cfg, tokens[:, 8:], cache)[0]

    before = decode()
    for _ in range(2):
        make, _, world = dryrun.mesh_for("1x1", False, "cpu")
        with dryrun.fake_group(world):
            mesh = make()
            r = dryrun.run_cell("granite3_8b", "dry_decode", mesh, cfg=cfg, device="cpu")
            del mesh
        assert r["status"] == "ok", r
    table = rope_frequencies(cfg.d_head, cfg.rope_theta, torch.device("cpu"))
    assert not isinstance(table, FakeTensor)
    after = decode()
    assert not isinstance(after, FakeTensor)
    assert torch.equal(before, after)


def test_sequence_sharded_cache_write_traces_under_fake_tensors():
    """The sequence-sharded cache write (granite's ``cache_seq`` over the
    model axis) with per-row starts that straddle the shards: a write of
    static shape, so it runs on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.distributed import sharding
    from repro_torch.models import attention

    rules = sharding.ShardingRules().replace(cache_seq="model")
    make, _, world = dryrun.mesh_for("2x2", False, "cpu")
    with dryrun.fake_group(world), dryrun.dtensor_bookkeeping():
        mesh = make()
        with FakeTensorMode(), sharding.use_mesh(mesh), sharding.use_rules(rules):
            buf = sharding.shard(torch.zeros(4, 32, 2, 8),
                                 ("batch", "cache_seq", "kv_heads", "head_dim"))
            upd = torch.ones(4, 3, 2, 8)
            attention.update_rows(buf, upd, torch.tensor([0, 14, 15, 31]))
            assert isinstance(buf.to_local(), FakeTensor)
            assert tuple(buf.to_local().shape) == (2, 16, 2, 8)
        del mesh


def test_mh_chain_fake_implementation():
    """``repro_torch::mh_chain`` on fake CUDA tensors: its fake
    implementation gives samples (K, B, C) int64 and accept (B, C) int32
    on the table's device, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.mh import mh

    before = dict(mh.LAUNCHES)
    with FakeTensorMode():
        table = torch.empty(3, 300, device="cuda")
        init = torch.empty(3, 5, dtype=torch.int64, device="cuda")
        flips = torch.empty(7, 3, 5, dtype=torch.int64, device="cuda")
        u = torch.empty(7, 3, 5, device="cuda")
        samples, accept = mh.mh_chain(table, init, flips, u, 9)
    assert (tuple(samples.shape), samples.dtype) == ((7, 3, 5), torch.int64)
    assert (tuple(accept.shape), accept.dtype) == ((3, 5), torch.int32)
    assert samples.device.type == accept.device.type == "cuda"
    assert mh.LAUNCHES == before


def _side_by_side() -> None:
    """Print each cell's FLOPs, temp bytes and collective bytes on both
    sides (``python tests/test_torch_dryrun.py --compare``): PERF.md's
    record of what the tests do not hold."""
    _register_shapes(configs)
    out = tempfile.mkdtemp(prefix="torch_dryrun_")
    subprocess.run([sys.executable, __file__, out], check=True, stdout=subprocess.DEVNULL)
    with open(os.path.join(out, "jax.json")) as f:
        jax_r = json.load(f)
    port_r = _port_cells()
    for key, j in jax_r.items():
        p = port_r[key]
        print(json.dumps({"cell": key, "flops": [p["hlo_cost"]["flops"], j["hlo_cost"]["flops"]],
                          "temp_bytes": [p["memory_analysis"]["temp_size_bytes"],
                                         j["memory_analysis"]["temp_size_bytes"]],
                          "collectives": [p["hlo_cost"]["collectives"],
                                          j["hlo_cost"]["collectives"]]}))


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        _side_by_side()
    else:
        _jax_reports(sys.argv[1])
