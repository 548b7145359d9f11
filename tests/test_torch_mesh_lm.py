"""The port's LLM mesh paths on 4 ``gloo`` ranks (the CPU stand-in for
four cards): the model sharding rules on DTensors, expert parallelism,
the ZeRO update and the compressed cross-pod train step, held against
the single-process port and the JAX package.

One subprocess, started by a module fixture with a time limit (a hung
rendezvous fails the tests instead of stalling the suite), runs every
case on the ranks and saves what the tests read.  The JAX reference is
computed here, in process, on one CPU device.  Tolerances, each stated
beside its check, are the reference's own where it has one:
``tests/test_distributed.py`` holds the mesh loss within ``rtol=2e-5``
and the decode logits within ``atol=3e-4``; gradients are held as
``tests/test_torch_train_loss.py`` holds them.

Run as a script (``python tests/test_torch_mesh_lm.py OUT PORT``) the
file starts the four ranks itself; it imports no JAX at module level.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as sh
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import activation
from repro_torch.optim import adamw
from repro_torch.training import step as step_mod

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LOSS_MESHES = {"layout_A": (2, 2), "layout_B": (1, 4)}  # (data, model); phi-3.5-MoE's kv = 2
COMPRESSED_MESHES = {"pod2_data2": (2, 2, 1), "pod2_model2": (2, 1, 2)}  # (pod, data, model)
# (data, model), and whether the residual stream is sharded over "model"
EMBED_MESHES = {"embed_A": ((2, 2), False), "embed_B": ((1, 4), False),
                "embed_SP": ((2, 2), True)}
EMBED_ARCH = "granite3_8b"
# smoke decodes on (data 2, model 2): name -> (arch, the cache_seq rule, prompt length)
DECODE_CASES = {
    # tests/test_distributed.py:146: the cache's sequence over "model"
    "decode": ("granite_34b", ("data", "model"), 8),
    # a prompt shorter than one shard (8 rows of the 16): in the decode step
    # the second "model" rank holds no valid position
    "decode_empty_shard": ("granite_34b", ("data", "model"), 3),
    # the cache whole over "model" (kv 1): each rank scores its 2 of 4 heads
    "decode_heads": ("granite3_8b", None, 8),
    # the cache's 2 KV heads split over "model" with the query's groups
    "decode_kv_heads": ("qwen3_moe_30b", None, 8),
}
STEP_ARCH, STEP_BATCH, STEP_SEQ, STEP_MICRO = "granite3_8b", 8, 16, 2
NO_CLIP = adamw.AdamWConfig(clip_norm=1e9)  # the clip inactive: AdamW exact


def _tokens(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _whole(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", np.arange(WORLD).reshape(shape).tolist(), mesh_dim_names=names)


# --- the cases (run on every rank) ---------------------------------------------


def _loss_case(shape):
    """phi-3.5-MoE's smoke loss and gradients on a (data, model) mesh."""
    cfg = configs.get_smoke_config("phi35_moe_42b")
    model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
    batch = _torch(_tokens(cfg, 4, 16, 1))
    mesh = _mesh(shape, ("data", "model"))
    with sh.use_mesh(mesh), sh.use_rules(sh.rules_for_config(cfg)):
        sh.distribute_params(model, mesh)
        loss, metrics = lm.train_loss(model, cfg, batch)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        out = {"loss": _whole(loss), "aux": _whole(metrics["aux_loss"]),
               "gqa_layout": np.array(_gqa_in(cfg))}
        out.update({f"grad/{n}": _whole(g) for n, g in zip(named, grads)})
    return out


def _gqa_in(cfg):
    from repro_torch.models import attention

    kv, r = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    return attention._gqa_layout(kv, r)


def _decode_roll(model, cfg, toks):
    cache = lm.init_cache(cfg, toks.shape[0], 16, device="cpu")
    logits, cache = lm.prefill(model, cfg, {"tokens": toks}, cache)
    nxt = _whole(logits)[:, :cfg.vocab_size].argmax(-1)[:, None].int()
    logits2, cache = lm.decode_step(model, cfg, nxt, cache)
    return _whole(logits), _whole(logits2), cache


def _decode_cfg(name):
    arch, cache_seq, _ = DECODE_CASES[name]
    cfg = configs.get_smoke_config(arch)
    if cache_seq is not None:
        cfg = dataclasses.replace(cfg, sharding_overrides=(("cache_seq", cache_seq),))
    return cfg


def _decode_toks(name):
    arch, _, prompt = DECODE_CASES[name]
    return torch.from_numpy(_tokens(configs.get_smoke_config(arch), 2, prompt, 1)["tokens"]).long()


def _decode_case(name):
    """A smoke decode on a (2, 2) mesh (``DECODE_CASES``), with the
    decode steps' calls of the sharded decode attention counted."""
    from repro_torch.models import attention

    cfg = _decode_cfg(name)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    mesh = _mesh((2, 2), ("data", "model"))
    real, calls = attention.decode_attention_sharded, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    attention.decode_attention_sharded = counted
    try:
        with sh.use_mesh(mesh), sh.use_rules(sh.rules_for_config(cfg)):
            sh.distribute_params(model, mesh)
            l1, l2, cache = _decode_roll(model, cfg, _decode_toks(name))
            k = cache["layers"]["k"]
            return {"prefill": l1, "decode": l2, "cache_k": _whole(k),
                    "sharded_calls": np.array(len(calls)),
                    "cache_split_dims": np.array([p.dim if p.is_shard() else -1
                                                  for p in k.placements])}
    finally:
        attention.decode_attention_sharded = real


def _embed_inputs(seq_shard=False):
    cfg = dataclasses.replace(configs.get_smoke_config(EMBED_ARCH), seq_shard=seq_shard)
    model = lm.init_lm(cfg, seed=4, device="cpu")
    rs = np.random.default_rng(6)
    tokens = torch.from_numpy(rs.integers(0, cfg.vocab_size, (4, 16)))
    dout = torch.from_numpy(rs.normal(size=(4, 16, cfg.d_model)).astype(np.float32))
    return cfg, model, tokens, dout


def _embed_case(shape, seq_shard):
    """The vocab-parallel embedding lookup on a (data, model) mesh: the
    rows, and the gradient of <rows, dout> on each rank's shard of the
    table (reduced over "data", the dimension that splits the batch)."""
    from torch.distributed.tensor import DTensor

    cfg, model, tokens, dout = _embed_inputs(seq_shard)
    mesh = _mesh(shape, ("data", "model"))
    with sh.use_mesh(mesh):
        sh.distribute_params(model, mesh)
        table = model.embed.requires_grad_(True)
        rows = lm._embed_tokens(table, cfg, tokens)
        d = DTensor.from_local(dout, mesh, [_replicate()] * 2, run_check=False).redistribute(
            mesh, rows.placements)
        (grad,) = torch.autograd.grad(rows, [table], d)
        (n, _), (lo, _) = sh.local_extent(table.shape, mesh, table.placements)
        return {"rows": _whole(rows), "rows_placements": np.array([str(p) for p in rows.placements]),
                "grad_shard": grad.redistribute(mesh, table.placements).to_local().detach(),
                "shard_rows": np.array([lo, n])}


def _moe_case():
    """qwen3-moe's smoke layer: moe_ffn_ep and the constrained local path
    on a (data 2, model 2) mesh, forward and gradients of <out, dout>."""
    from torch.distributed.tensor import DTensor

    cfg = configs.get_smoke_config("qwen3_moe_30b")
    params = moe_mod.init_moe(torch.Generator().manual_seed(3), cfg)
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.normal(size=(4, 8, cfg.d_model)).astype(np.float32))
    dout = torch.from_numpy(rs.normal(size=(4, 8, cfg.d_model)).astype(np.float32))
    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    with sh.use_mesh(mesh):
        holder = torch.nn.Module()
        holder.moe = params
        holder.param_axes = {f"moe.{n}": p.logical_axes for n, p in params.items()}
        sh.distribute_params(holder, mesh)
        placed = {k: v.requires_grad_(True) for k, v in holder.moe.items()}
        for path in ("ep", "local"):
            xd = sh.shard(x, ("batch", "seq", "embed")).detach().requires_grad_(True)
            if path == "ep":
                y, aux = moe_mod.moe_ffn_ep(placed, xd, cfg, activation(cfg.act), mesh)
            else:
                y, aux = moe_mod.moe_ffn_local(placed, xd, cfg, activation(cfg.act),
                                               constrain=True)
            d = DTensor.from_local(dout, mesh, [_replicate()] * 2, run_check=False).redistribute(
                mesh, y.placements)
            leaves = [xd, *placed.values()]
            grads = torch.autograd.grad(y, leaves, d)
            out[f"{path}/out"], out[f"{path}/aux"] = _whole(y), _whole(aux)
            for n, g in zip(["x", *placed], grads):
                out[f"{path}/grad/{n}"] = _whole(g)
    # the dispatcher on a mesh whose "model" extent (1) cannot split the
    # experts: the unconstrained path, its rows over "data"
    data_mesh = _mesh((4, 1), ("data", "model"))
    with sh.use_mesh(data_mesh):
        holder = torch.nn.Module()
        holder.moe = moe_mod.init_moe(torch.Generator().manual_seed(3), cfg)
        holder.param_axes = {f"moe.{n}": p.logical_axes for n, p in holder.moe.items()}
        sh.distribute_params(holder, data_mesh)
        y, aux = moe_mod.moe_ffn(dict(holder.moe.items()), sh.shard(x, ("batch", "seq", "embed")),
                                 cfg, activation(cfg.act))
        out["data_only/out"], out["data_only/aux"] = _whole(y), _whole(aux)
    return out


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def _loss_terms_inputs():
    """granite's smoke head (259 of 512 columns real, so the second
    "model" rank holds 3) with a z-loss, a hidden chunk and its labels,
    some masked."""
    cfg = dataclasses.replace(configs.get_smoke_config(EMBED_ARCH), z_loss=1e-4)
    model = lm.init_lm(cfg, seed=5, device="cpu").requires_grad_(True)
    rs = np.random.default_rng(8)
    h = torch.from_numpy(rs.normal(size=(4, 16, cfg.d_model)).astype(np.float32))
    lab = torch.from_numpy(rs.integers(-1, cfg.vocab_size, (4, 16)))
    return cfg, model, h, lab


def _loss_terms_case():
    """The vocab-parallel chunk terms on a (data 2, model 2) mesh: the
    label's logit and logsumexp, the chunk's (nll, z, count) and the
    gradients of nll + z with respect to the hidden chunk and the head."""
    cfg, model, h, lab = _loss_terms_inputs()
    mesh = _mesh((2, 2), ("data", "model"))
    with sh.use_mesh(mesh), sh.use_rules(sh.rules_for_config(cfg)):
        sh.distribute_params(model, mesh)
        hd = sh.shard(h, ("batch", "seq", "embed")).detach().requires_grad_(True)
        logits = lm.head_logits(model, cfg, hd)
        logz, ll = lm._vocab_parallel_terms(logits.detach(), lab)
        nll, zl, n = lm._chunk_terms(model, cfg, hd, lab)
        g_h, g_head = torch.autograd.grad(nll + zl, [hd, model.lm_head])
        return {"logits_placements": np.array([str(p) for p in logits.placements]),
                "logz": _whole(logz), "ll": _whole(ll), "nll": _whole(nll), "z": _whole(zl),
                "count": _whole(n), "grad/h": _whole(g_h), "grad/lm_head": _whole(g_head)}


def _zero_case():
    """One AdamW update with ZeRO axes over data on a (data 2, model 2)
    mesh, from gradients every rank holds alike."""
    cfg = configs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    rs = np.random.default_rng(5)
    grads = {n: torch.from_numpy(rs.normal(size=tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    mesh = _mesh((2, 2), ("data", "model"))
    with sh.use_mesh(mesh):
        sh.distribute_params(model, mesh)
        named = dict(model.named_parameters())
        placed = {n: sh.shard(g, sh.leaf_axes(model.param_axes[n], g.ndim))
                  for n, g in grads.items()}
        opt = adamw.adamw_init(model)
        for _ in range(2):
            model, opt, metrics = adamw.adamw_update(placed, opt, model, NO_CLIP,
                                                     axes_tree=model.param_axes)
        out = {"grad_norm": _whole(metrics["grad_norm"])}
        zero_sharded = 0
        for n, p in named.items():
            out[f"param/{n}"] = _whole(p)
            out[f"m/{n}"], out[f"v/{n}"] = _whole(opt["m"][n]), _whole(opt["v"][n])
            zaxes = adamw.zero_axes_tree(model, model.param_axes)[n]
            zero_sharded += "_zero" in zaxes and any(
                pl.is_shard() for pl, dim in zip(
                    opt["m"][n].placements, sh.mesh_axis_names(mesh)) if dim == "data")
        out["zero_sharded_leaves"] = np.array(zero_sharded)
    return out


def _train_step_case():
    """make_train_step over a (data 2, model 2) mesh with ZeRO axes, two
    steps of 2 microbatches."""
    cfg = configs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    mesh = _mesh((2, 2), ("data", "model"))
    fn = step_mod.make_train_step(cfg, axes_tree=model.param_axes,
                                  step_cfg=step_mod.TrainStepConfig(n_micro=STEP_MICRO),
                                  mesh=mesh)
    with sh.use_mesh(mesh):
        sh.distribute_params(model, mesh)
        opt = adamw.adamw_init(model)
    out = {}
    for t in range(2):
        model, opt, m = fn(model, opt, _torch(_tokens(cfg, STEP_BATCH, STEP_SEQ, 10 + t)))
        out[f"loss_{t}"], out[f"grad_norm_{t}"] = m["loss"], m["grad_norm"]
    with sh.use_mesh(mesh):
        out.update({f"param/{n}": _whole(p) for n, p in model.named_parameters()})
    return out


def _compressed_case(shape):
    """One compressed-pod step (n_micro = 2) on a (pod, data, model) mesh,
    with what went into and came out of compressed_pmean captured."""
    cfg = configs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    mesh = _mesh(shape, ("pod", "data", "model"))
    seen = {}
    real = step_mod.compressed_pmean

    def capture(grads, err, **kw):
        red, new_err = real(grads, err, **kw)
        seen.update({f"in/{n}": _whole(g) for n, g in grads.items()})
        seen.update({f"err_in/{n}": _whole(e) for n, e in err.items()})
        seen.update({f"red/{n}": _whole(g) for n, g in red.items()})
        seen.update({f"err/{n}": _whole(e) for n, e in new_err.items()})
        return red, new_err

    fn = step_mod.make_train_step(
        cfg, axes_tree=model.param_axes, opt_cfg=NO_CLIP,
        step_cfg=step_mod.TrainStepConfig(n_micro=STEP_MICRO, compress_pods=True), mesh=mesh)
    with sh.use_mesh(mesh):
        sh.distribute_params(model, mesh)
        opt = adamw.adamw_init(model)
        err = compression.init_error_state(dict(model.named_parameters()))
    step_mod.compressed_pmean = capture
    compression.PAYLOAD.clear()
    try:
        model, opt, metrics, err = fn(model, opt, _torch(_tokens(cfg, STEP_BATCH, STEP_SEQ, 7)),
                                      err)
    finally:
        step_mod.compressed_pmean = real
    out = {k: v for k, v in seen.items()}
    out["pod"] = np.array(mesh.get_local_rank(0))
    out["payload"] = np.array([compression.PAYLOAD[k] for k in ("int32", "float32")])
    out["payload_dtypes"] = np.array(sorted(compression.PAYLOAD))
    out.update({f"metric/{k}": v for k, v in metrics.items()})
    with sh.use_mesh(mesh):
        out.update({f"param/{n}": _whole(p) for n, p in model.named_parameters()})
        out.update({f"err_out/{n}": _whole(e) for n, e in err.items()})
    return out


def _mesh_builders():
    from repro_torch.launch import mesh as tmesh

    out = {}
    alt = tmesh.alt_mesh(2, 2, device_type="cpu")
    out["alt"] = np.array([*alt.mesh_dim_names, *map(str, alt.mesh.shape)])
    alt3 = tmesh.alt_mesh(1, 2, pods=2, device_type="cpu")
    out["alt_pods"] = np.array([*alt3.mesh_dim_names, *map(str, alt3.mesh.shape)])
    for multi in (False, True):
        try:
            tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
            out[f"production_{multi}"] = np.array("built")
        except ValueError as e:
            out[f"production_{multi}"] = np.array(str(e))
    return out


def _save(out, name, rank, arrays):
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
             **{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in arrays.items()})


def _rank(rank, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        _save(out, "builders", rank, _mesh_builders())
        for name, shape in LOSS_MESHES.items():
            _save(out, name, rank, _loss_case(shape))
        for name, (shape, seq_shard) in EMBED_MESHES.items():
            _save(out, name, rank, _embed_case(shape, seq_shard))
        for name in DECODE_CASES:
            _save(out, name, rank, _decode_case(name))
        _save(out, "moe", rank, _moe_case())
        _save(out, "loss_terms", rank, _loss_terms_case())
        _save(out, "zero", rank, _zero_case())
        _save(out, "train_step", rank, _train_step_case())
        for name, shape in COMPRESSED_MESHES.items():
            _save(out, name, rank, _compressed_case(shape))
    finally:
        dist.destroy_process_group()


def _launch(out, port):
    import torch.multiprocessing as mp

    torch.set_num_threads(1)
    mp.spawn(_rank, args=(port, out), nprocs=WORLD)


# --- the tests -------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    """{case: [each rank's saved arrays]}."""
    out = tempfile.mkdtemp(prefix="torch_mesh_lm_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, __file__, out, str(_free_port())], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = ("builders", *LOSS_MESHES, *EMBED_MESHES, *DECODE_CASES, "moe", "loss_terms", "zero",
             "train_step", *COMPRESSED_MESHES)
    return {n: [dict(np.load(os.path.join(out, f"{n}_rank{r}.npz"))) for r in range(WORLD)]
            for n in names}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("layout", list(LOSS_MESHES))
def test_mesh_loss_matches_single_process(ranks, layout):
    """tests/test_distributed.py:120 on the port: the loss over the mesh
    within rtol=2e-5 of the single-process loss; (2, 2) takes layout A
    (kv 2 divides "model"), (1, 4) layout B (K/V repeated to 4 heads)."""
    cfg = configs.get_smoke_config("phi35_moe_42b")
    model = lm.init_lm(cfg, seed=0, device="cpu")
    loss, metrics = lm.train_loss(model, cfg, _torch(_tokens(cfg, 4, 16, 1)))
    kv, r = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    want_layout = (kv, r, False) if layout == "layout_A" else (kv * r, 1, True)
    for got in ranks[layout]:
        assert tuple(got["gqa_layout"].tolist()) == want_layout
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=2e-5)
        np.testing.assert_allclose(float(got["aux"]), float(metrics["aux_loss"]), rtol=2e-5)


@pytest.mark.parametrize("layout", list(LOSS_MESHES))
def test_mesh_gradients_match_single_process(ranks, layout):
    """The gradients over the mesh, each leaf within 2e-4 of the largest
    gradient (test_torch_train_loss.py's bound; measured 1.5e-5)."""
    cfg = configs.get_smoke_config("phi35_moe_42b")
    model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
    loss, _ = lm.train_loss(model, cfg, _torch(_tokens(cfg, 4, 16, 1)))
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    scale = max(float(g.abs().max()) for g in grads.values())
    for got in ranks[layout]:
        diff = max(float(np.abs(got[f"grad/{n}"] - g.numpy()).max()) for n, g in grads.items())
        assert diff <= 2e-4 * scale, (diff, scale)


def _hold_decode(ranks, name, split_dims):
    cfg = _decode_cfg(name)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    l1, l2, cache = _decode_roll(model, cfg, _decode_toks(name))
    for got in ranks[name]:
        # (L, B, Smax, KV, dh): the batch over "data"; "model" as the case says
        assert got["cache_split_dims"].tolist() == split_dims
        assert int(got["sharded_calls"]) == cfg.n_layers  # the decode step's layers
        np.testing.assert_allclose(got["prefill"], l1.numpy(), atol=3e-4)
        np.testing.assert_allclose(got["decode"], l2.numpy(), atol=3e-4)
        np.testing.assert_allclose(got["cache_k"], cache["layers"]["k"].numpy(), atol=3e-4)


def test_decode_with_seq_sharded_cache_matches_single_process(ranks):
    """tests/test_distributed.py:146 on the port: prefill and decode
    logits within atol=3e-4 with the KV cache sharded over its sequence
    ("model": "data" is taken by the batch), the cache itself likewise;
    the decode step scores each rank's rows of the cache."""
    _hold_decode(ranks, "decode", [1, 2])


@pytest.mark.parametrize("name,split_dims", [("decode_empty_shard", [1, 2]),
                                             ("decode_heads", [1, -1]),
                                             ("decode_kv_heads", [1, 3])])
def test_decode_plans_match_single_process(ranks, name, split_dims):
    """The decode attention's other plans, within the same atol=3e-4: a
    shard of the sequence with no valid position (it weighs zero, not
    NaN); the cache whole over "model" with the query's heads split; the
    cache's KV heads split with their groups."""
    _hold_decode(ranks, name, split_dims)


@pytest.mark.parametrize("mesh", list(EMBED_MESHES))
def test_vocab_parallel_embedding_matches_lookup(ranks, mesh):
    """The vocab-parallel lookup on (2, 2) and (1, 4) equals the lookup
    without a mesh bit for bit (one non-zero term an element), laid out
    ("batch", "seq", "embed"), or ("batch", "seq_sp", "embed") when the
    residual stream is sharded (the sum a reduce-scatter); each rank's
    shard of the table's gradient is the unmeshed gradient's rows of that
    shard, within 1e-6 of its largest value (repeated tokens' terms
    summed over "data" in another order)."""
    (data, _), seq_shard = EMBED_MESHES[mesh]
    cfg, model, tokens, dout = _embed_inputs(seq_shard)
    table = model.embed.requires_grad_(True)
    rows = lm._embed_tokens(table, cfg, tokens)
    (grad,) = torch.autograd.grad(rows, [table], dout)
    seen = set()
    for got in ranks[mesh]:
        np.testing.assert_array_equal(got["rows"], rows.detach().numpy())
        # the batch over "data"; the sequence over "model" under seq_shard
        assert got["rows_placements"].tolist() == ["S(0)", "S(1)" if seq_shard else "R"]
        lo, n = got["shard_rows"].tolist()
        assert n == cfg.padded_vocab * data // WORLD
        want = grad[lo:lo + n].numpy()
        assert float(np.abs(got["grad_shard"] - want).max()) <= 1e-6 * float(
            np.abs(grad.numpy()).max())
        seen.add(lo)
    assert len(seen) == WORLD // data  # every shard of the table is some rank's


def test_moe_ffn_ep_matches_local(ranks):
    """moe_ffn_ep against the constrained local path on the same mesh and
    against the single-process moe_ffn_local, forward and the gradients
    of <out, dout> (x, router and experts): within 1e-5 of the largest
    value (sums over ranks in another order; measured 5e-7); and
    ``moe_ffn`` on a data-only mesh (its unconstrained path)."""
    cfg = configs.get_smoke_config("qwen3_moe_30b")
    params = moe_mod.init_moe(torch.Generator().manual_seed(3), cfg).requires_grad_(True)
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.normal(size=(4, 8, cfg.d_model)).astype(np.float32))
    dout = torch.from_numpy(rs.normal(size=(4, 8, cfg.d_model)).astype(np.float32))
    x.requires_grad_(True)
    y, aux = moe_mod.moe_ffn_local(dict(params), x, cfg, activation(cfg.act))
    grads = torch.autograd.grad(y, [x, *params.values()], dout)
    want = {"out": y.detach(), "aux": aux.detach()}
    want.update({f"grad/{n}": g for n, g in zip(["x", *params], grads)})
    for got in ranks["moe"]:
        for path in ("ep", "local"):
            for k, w in want.items():
                assert _rel(got[f"{path}/{k}"], w.numpy()) <= 1e-5, (path, k)
        # rows split over "data" only: every row's sums as on one device
        for k in ("out", "aux"):
            assert _rel(got[f"data_only/{k}"], want[k].numpy()) <= 1e-6, k


def test_meshed_moe_combine_equals_unmeshed(ranks):
    """The constrained local path on (2, 2), whose combine reduces each
    rank's contributions (one non-zero term an element) instead of
    gathering the experts' outputs, against the unmeshed
    ``moe_ffn_local``: the output and the aux loss bit for bit."""
    cfg = configs.get_smoke_config("qwen3_moe_30b")
    params = moe_mod.init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 8, cfg.d_model))
                         .astype(np.float32))
    y, aux = moe_mod.moe_ffn_local(dict(params), x, cfg, activation(cfg.act))
    for got in ranks["moe"]:
        np.testing.assert_array_equal(got["local/out"], y.detach().numpy())
        np.testing.assert_array_equal(got["local/aux"], aux.detach().numpy())


def test_vocab_parallel_loss_terms_match_unmeshed(ranks):
    """The chunk terms from vocab-sharded logits on (2, 2) against the
    unmeshed ones: the label's logit bit for bit (a masked partial sum
    with one non-zero term); the logsumexp, the nll and z sums within the
    mesh loss's rtol=2e-5; the count exactly; the gradients within 2e-4
    of the largest (the mesh gradient tests' bound).  The logits stay
    split over "model"."""
    cfg, model, h, lab = _loss_terms_inputs()
    h.requires_grad_(True)
    logits = lm.head_logits(model, cfg, h)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, lab.clamp_min(0)[..., None], dim=-1)[..., 0]
    nll, zl, n = lm._chunk_terms(model, cfg, h, lab)
    grads = dict(zip(("h", "lm_head"), torch.autograd.grad(nll + zl, [h, model.lm_head])))
    nll, zl = nll.detach(), zl.detach()
    for got in ranks["loss_terms"]:
        assert got["logits_placements"].tolist() == ["S(0)", "S(2)"]
        np.testing.assert_array_equal(got["ll"], ll.detach().numpy())
        np.testing.assert_allclose(got["logz"], logz.detach().numpy(), rtol=2e-5)
        np.testing.assert_allclose(float(got["nll"]), float(nll), rtol=2e-5)
        np.testing.assert_allclose(float(got["z"]), float(zl), rtol=2e-5)
        assert float(got["count"]) == float(n)
        for k, g in grads.items():
            diff = float(np.abs(got[f"grad/{k}"] - g.numpy()).max())
            assert diff <= 2e-4 * float(g.abs().max()), (k, diff)


def test_zero_update_matches_unsharded(ranks):
    """Two AdamW steps with ZeRO axes over the mesh against the unsharded
    update from the same gradients: parameters and moments bit for bit
    (the clip inactive, every term elementwise); the global norm within
    1e-6 relative (its sum runs in another order); every leaf with a
    ZeRO dim keeps its moments split over "data"."""
    cfg = configs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    rs = np.random.default_rng(5)
    grads = {n: torch.from_numpy(rs.normal(size=tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    opt = adamw.adamw_init(model)
    for _ in range(2):
        model, opt, metrics = adamw.adamw_update(grads, opt, model, NO_CLIP)
    with sh.use_mesh(sh.AbstractMesh((2, 2), ("data", "model"))):
        zaxes = adamw.zero_axes_tree(model, model.param_axes)
    n_zero = sum("_zero" in a for a in zaxes.values())
    assert n_zero > 0
    for got in ranks["zero"]:
        assert int(got["zero_sharded_leaves"]) == n_zero
        assert _rel(got["grad_norm"], metrics["grad_norm"].numpy()) <= 1e-6
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(got[f"param/{n}"], p.detach().numpy(), err_msg=n)
            np.testing.assert_array_equal(got[f"m/{n}"], opt["m"][n].numpy(), err_msg=n)
            np.testing.assert_array_equal(got[f"v/{n}"], opt["v"][n].numpy(), err_msg=n)


def test_mesh_train_step_matches_unsharded(ranks):
    """make_train_step over the mesh (2 microbatches, ZeRO) against the
    unsharded step: losses within rtol=2e-5, gradient norms within 1e-4
    relative, parameters within 1e-4 (Adam moves a parameter by up to lr
    = 3e-4 a step whatever its gradient's rounding; measured 2e-6)."""
    cfg = configs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    fn = step_mod.make_train_step(cfg, step_cfg=step_mod.TrainStepConfig(n_micro=STEP_MICRO))
    opt = adamw.adamw_init(model)
    want = []
    for t in range(2):
        model, opt, m = fn(model, opt, _torch(_tokens(cfg, STEP_BATCH, STEP_SEQ, 10 + t)))
        want.append(m)
    for got in ranks["train_step"]:
        for t, m in enumerate(want):
            np.testing.assert_allclose(float(got[f"loss_{t}"]), float(m["loss"]), rtol=2e-5)
            np.testing.assert_allclose(float(got[f"grad_norm_{t}"]), float(m["grad_norm"]),
                                       rtol=1e-4)
        for n, p in model.named_parameters():
            assert float(np.abs(got[f"param/{n}"] - p.detach().numpy()).max()) <= 1e-4, n


# --- the compressed-pod step against the JAX composite ---------------------------


@functools.lru_cache(maxsize=None)
def _jax_composite(n_pods):
    """The reference's compressed step, assembled as its
    training/step.py:121-147 assembles it: JAX's per-pod
    _accumulated_grads on the pod's rows, from the port's weights
    (computed once for both meshes of two pods)."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.training import step as jstep

    jcfg = jconfigs.get_smoke_config(STEP_ARCH)
    model = lm.init_lm(configs.get_smoke_config(STEP_ARCH), seed=2, device="cpu")
    values = convert.lm_to_numpy(model)
    batch = _tokens(jcfg, STEP_BATCH, STEP_SEQ, 7)
    rows = STEP_BATCH // n_pods
    fn = jax.jit(lambda v, b: jstep._accumulated_grads(
        lambda v_, b_: jlm.train_loss(v_, jcfg, b_), v, b, STEP_MICRO))
    pods = []
    for p in range(n_pods):
        loss, metrics, grads = fn(values, {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()})
        flat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
        pods.append((float(loss), flat))
    return model, pods


def _port_tree(model, arrays, prefix):
    names = [n for n, _ in model.named_parameters()]
    tree = convert.named_to_tree({n: arrays[f"{prefix}{n}"] for n in names})
    import jax

    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("mesh", list(COMPRESSED_MESHES))
def test_compressed_step_gradients_match_jax(ranks, mesh):
    """Each pod's accumulated gradients (what enters compressed_pmean)
    against JAX's _accumulated_grads on the pod's rows: within 2e-4 of
    the largest gradient (test_torch_train_loss.py); the step's loss, the
    mean over pods, within 5e-6."""
    model, pods = _jax_composite(COMPRESSED_MESHES[mesh][0])
    for got in ranks[mesh]:
        loss, jgrads = pods[int(got["pod"])]
        ported = _port_tree(model, got, "in/")
        assert list(ported) == list(jgrads)
        scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
        diff = max(float(np.abs(np.asarray(jgrads[k]) - ported[k]).max()) for k in jgrads)
        assert diff <= 2e-4 * scale, (diff, scale)
        assert not any(np.any(got[f"err_in/{n}"]) for n, _ in model.named_parameters())
    mean_loss = float(np.mean([p[0] for p in pods]))
    for got in ranks[mesh]:
        assert abs(float(got["metric/loss"]) - mean_loss) <= 5e-6


@pytest.mark.parametrize("mesh", list(COMPRESSED_MESHES))
def test_compressed_step_words_and_errors_match_jax(ranks, mesh):
    """JAX's compressed_pmean (under vmap over the pods) applied to the
    port's own per-pod gradients: the reduced gradients and error states
    bit for bit; the new error state the step returns is its pod's."""
    import jax

    from repro.distributed.compression import compressed_pmean

    names = [n for n, _ in lm.init_lm(configs.get_smoke_config(STEP_ARCH), seed=2,
                                      device="cpu").named_parameters()]
    n_pods = COMPRESSED_MESHES[mesh][0]
    by_pod = {int(got["pod"]): got for got in ranks[mesh]}
    g = {n: np.stack([by_pod[p][f"in/{n}"] for p in range(n_pods)]) for n in names}
    e = {n: np.stack([by_pod[p][f"err_in/{n}"] for p in range(n_pods)]) for n in names}
    red, err = jax.jit(jax.vmap(lambda g_, e_: compressed_pmean(g_, e_, "pod"),
                                axis_name="pod"))(g, e)
    for got in ranks[mesh]:
        p = int(got["pod"])
        for n in names:
            np.testing.assert_array_equal(got[f"red/{n}"], np.asarray(red[n][p]), err_msg=n)
            np.testing.assert_array_equal(got[f"err/{n}"], np.asarray(err[n][p]), err_msg=n)
            np.testing.assert_array_equal(got[f"err_out/{n}"], got[f"err/{n}"], err_msg=n)


@functools.lru_cache(maxsize=None)
def _jax_update():
    """JAX's adamw_update, jitted: the port reproduces XLA's compile of
    the update (its FMAs); the clip inactive."""
    import jax

    from repro.optim import adamw as jadamw

    return jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jadamw.AdamWConfig(
        clip_norm=1e9)))


@pytest.mark.parametrize("mesh", list(COMPRESSED_MESHES))
def test_compressed_step_update_matches_jax(ranks, mesh):
    """The update outside the pod region: JAX's adamw_update of the port's
    reduced gradients (equal on every pod) gives the port's new
    parameters bit for bit (the clip inactive); the pod all-reduce sent
    int32 words and one float32 scale a leaf."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw

    model = lm.init_lm(configs.get_smoke_config(STEP_ARCH), seed=2, device="cpu")
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    n_leaves = len(params)
    update = _jax_update()
    for got in ranks[mesh]:
        grads = {n: jnp.asarray(got[f"red/{n}"]) for n in params}
        new, _, _ = update(grads, jadamw.adamw_init(params), params)
        for n in params:
            np.testing.assert_array_equal(got[f"param/{n}"], np.asarray(new[n]), err_msg=n)
        assert got["payload_dtypes"].tolist() == ["float32", "int32"]
        assert int(got["payload"][1]) == 4 * n_leaves


def test_mesh_builders(ranks):
    """alt_mesh builds the reference's names and shapes on 4 ranks;
    make_production_mesh needs 256 (512) ranks and says so."""
    for got in ranks["builders"]:
        assert got["alt"].tolist() == ["data", "model", "2", "2"]
        assert got["alt_pods"].tolist() == ["pod", "data", "model", "2", "1", "2"]
        assert "world size 256" in str(got["production_False"])
        assert "world size 512" in str(got["production_True"])


if __name__ == "__main__":
    _launch(sys.argv[1], int(sys.argv[2]))
