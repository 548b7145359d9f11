"""The port's training half against the JAX package's: the optimizer
and its schedules, the synthetic data, and the train step with gradient
accumulation and per-block recomputation (``tests/test_substrates.py``).
The launcher is held in ``tests/test_torch_train_launch.py``, the loss and
gradients of every architecture in ``tests/test_torch_train_loss.py``.

The same inputs, made from a seed with numpy, go through the JAX
function and its port in float32 on the CPU.  Integer results (data
batches, tokens, step counts) are held exactly; floats within the
tolerance stated beside each check, the largest difference measured on
these inputs (jax 0.9.0, torch 2.13.0, CPU), rounded up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.training import step as jstep
from repro_torch import configs, convert
from repro_torch.data import pipeline as data
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule
from repro_torch.training import step

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carried(arch, seed=1, **replace):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    values = jax.jit(lambda k: jlm.init_lm_values(k, jcfg)[0])(jax.random.PRNGKey(seed))
    values = jax.tree.map(np.asarray, values)
    return jcfg, tcfg, values, convert.lm_from_numpy(values, tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _max_diff_tree(jtree, named: dict) -> tuple[float, float]:
    """(largest |JAX - port| over the leaves, largest |JAX|) of a JAX value
    tree and the port's values keyed by parameter name."""
    ported = convert.named_to_tree({n: t.detach().float().numpy() for n, t in named.items()})
    fj = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    ft = dict(jax.tree_util.tree_flatten_with_path(ported)[0])
    assert list(fj) == list(ft)
    diff = max(float(np.abs(np.asarray(fj[k], np.float32) - ft[k]).max()) for k in fj)
    return diff, max(float(np.abs(np.asarray(fj[k], np.float32)).max()) for k in fj)


# --- schedules and AdamW ---------------------------------------------------------


@pytest.mark.parametrize("fn,args", [("linear_warmup", (7,)), ("cosine_schedule", (5, 40)),
                                     ("cosine_schedule", (20, 100)),
                                     ("cosine_schedule", (3, 1000, 0.2))])
def test_schedules(fn, args):
    steps = np.arange(1200, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: getattr(jschedule, fn)(s, *args)))(steps))
    out = getattr(schedule, fn)(torch.from_numpy(steps), *args)
    assert out.dtype == torch.float32
    # the jitted JAX function: a division by a constant is a reciprocal
    # multiply, the cosine's multiply-add one fused multiply-add; the port
    # does the same, and differs only where torch's cos and XLA's part in
    # the last bit: measured 1.2e-7 at most (values up to 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2.5e-7)
    assert float(getattr(schedule, fn)(5, *args)) == pytest.approx(float(ref[5]), abs=2.5e-7)


def _adamw_inputs(seed, bf16):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 33), "b": (7,), "c": (3, 5, 11)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if bf16:
        params = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in params.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    return params, grads


def _bf16_tensor(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("clip_norm,use_master", [(1e9, False), (1e9, True), (1.0, False),
                                                  (1.0, True)])
def test_adamw_steps(clip_norm, use_master):
    """Four steps with a schedule's scale: with the clip inactive the port
    is JAX's bit for bit (the fused multiply-adds XLA makes included);
    clipping divides by the global norm, whose float32 sum the two
    packages add in other orders."""
    cfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip_norm, use_master=use_master)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    params, grads = _adamw_inputs(0, bf16=use_master)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.adamw_init(jparams, cfg)
    tparams = {k: _bf16_tensor(v) for k, v in params.items()}
    tstate = adamw.adamw_init(tparams, tcfg)
    update = jax.jit(lambda g, s, p, scale: jadamw.adamw_update(g, s, p, cfg, scale))
    for i, g in enumerate(grads):
        scale = np.float32(0.3 + 0.2 * i)
        jparams, jstate, jm = update(g, jstate, jparams, scale)
        _, tstate, tm = adamw.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                           tstate, tparams, tcfg, torch.tensor(scale))
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        # measured: the global norms 9.5e-7 apart (norms near 14)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 5e-6
        assert float(tm["lr"]) == float(jm["lr"])
        exact = clip_norm > 1e8
        for k in params:
            for name, j, t in (("p", jparams[k], tparams[k]), ("m", jstate["m"][k],
                                                            tstate["m"][k]),
                               ("v", jstate["v"][k], tstate["v"][k])) + (
                    (("master", jstate["master"][k], tstate["master"][k]),) if use_master
                    else ()):
                j32, t32 = np.asarray(j, np.float32), t.float().numpy()
                if exact:
                    np.testing.assert_array_equal(j32, t32, err_msg=f"{name} {k} step {i}")
                else:
                    # measured, relative to the leaf's largest value: v
                    # 2.9e-7, m 1.5e-7, master 9.0e-8, p 3.1e-8
                    np.testing.assert_allclose(t32, j32, rtol=0,
                                               atol=1e-6 * float(np.abs(j32).max()),
                                               err_msg=f"{name} {k} step {i}")
        if use_master:
            assert all(t.dtype == torch.bfloat16 for t in tparams.values())


def _bits(x: torch.Tensor) -> int:
    assert x.dtype == torch.float32 and x.shape == ()
    return int(x.view(torch.int32))


def _host_cosine(step, warmup_steps, total_steps, final_frac=0.1):
    """``schedule.cosine_schedule`` as it was before its constants became
    fills on the device: each copied from the host by ``torch.tensor``."""
    step = (step.float() if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = torch.clamp_max(schedule._over(step + 1.0, max(1.0, float(warmup_steps))), 1.0)
    progress = torch.clamp(
        schedule._over(step - warmup_steps, max(1.0, float(total_steps - warmup_steps))),
        0.0, 1.0)
    wave = 1.0 + torch.cos(progress * float(np.float32(np.pi)))
    cos = adamw.fma(wave, torch.tensor(np.float32((1.0 - final_frac) * 0.5)),
                    torch.full_like(wave, final_frac))
    return torch.where(step < warmup_steps, warm, cos)


def test_device_fills_equal_the_host_constants():
    """The constants a captured train step cannot copy from the host are
    fills on the device (``torch.full((), np.float32(x))``): each equals
    the ``torch.tensor(np.float32(x))`` it replaced bit for bit, the
    schedules over steps 0-30 (a Python step and a tensor one) are what
    they were, and so are a Python ``lr_scale``'s ``lr`` and the loss's
    ``aux_loss`` of a family without a router."""
    cfg = adamw.AdamWConfig()
    like = torch.zeros(3)
    for x in (cfg.b1, cfg.b2, 1.0 - cfg.b1, 1.0 - cfg.b2, cfg.weight_decay, 0.45, 1 / 3):
        assert _bits(adamw._scalar(x, like)) == _bits(torch.tensor(np.float32(x)))
    for s in range(31):
        assert _bits(schedule._f32(s)) == _bits(torch.tensor(float(s), dtype=torch.float32))
        for args in ((5, 40), (0, 30), (20, 25)):
            for step_ in (s, torch.tensor(s, dtype=torch.int32)):
                assert _bits(schedule.cosine_schedule(step_, *args)) == _bits(
                    _host_cosine(step_, *args)), (s, args)
    params = {"w": torch.ones(4)}
    for scale in (1.0, 0.3, 1 / 7):
        _, _, metrics = adamw.adamw_update({"w": torch.ones(4)}, adamw.adamw_init(params),
                                           params, cfg, scale)
        assert _bits(metrics["lr"]) == _bits(
            torch.as_tensor(scale, dtype=torch.float32) * cfg.lr)
    tcfg = configs.get_smoke_config("granite3_8b")
    model = lm.init_lm(tcfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        _, metrics = lm.train_loss(model, tcfg, {"tokens": tokens, "labels": tokens})
    assert _bits(metrics["aux_loss"]) == _bits(torch.tensor(0.0, dtype=torch.float32))


def test_fma_is_one_rounding():
    """``adamw.fma`` (``torch.addcmul``) rounds once, as XLA's contracted
    multiply-adds do: equal to the emulation ``prng._fma32`` on a million
    values whose product and addend are of a size, with a tensor or 0-d
    multiplier, contiguous or strided; the unfused sum differs."""
    from repro_torch.prng import _fma32

    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(1_000_003, generator=gen) for _ in range(3))
    ref = _fma32(a, b, c)
    assert torch.equal(adamw.fma(a, b, c), ref)
    assert not torch.equal(a * b + c, ref)
    assert torch.equal(adamw.fma(a[::3], b[::3], c[::3]), ref[::3])
    w = torch.tensor(np.float32(0.95))
    assert torch.equal(adamw.fma(a, w, c), _fma32(a, w.expand_as(a), c))


def test_global_norm():
    rng = np.random.default_rng(3)
    tree = {k: rng.standard_normal((5, 9)).astype(np.float32) for k in "abc"}
    ref = float(jadamw.global_norm(tree))
    out = float(adamw.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    assert out == pytest.approx(ref, rel=1e-6)


# --- data ------------------------------------------------------------------------


@partitionable
@pytest.mark.parametrize("source", ["markov", "uniform"])
def test_data_batches_equal_jax(source):
    """Global batches, host slices and the iterator, token for token."""
    for vocab, seq, batch, seed in ((257, 16, 4, 0), (32001, 24, 6, 3)):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed, source=source)
        ref = jdata.SyntheticTokenPipeline(jdata.DataConfig(**kw))
        out = data.SyntheticTokenPipeline(data.DataConfig(**kw), device="cpu")
        for t in (0, 5):
            jb, tb = ref.global_batch(t), out.global_batch(t)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int32
                np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy(), err_msg=k)
        # host sharding: each host's slice of the same global batch
        hosts = 2 if batch == 4 else 3
        slices = []
        for h in range(hosts):
            cfg = data.DataConfig(**kw, n_hosts=hosts, host_id=h)
            part = data.SyntheticTokenPipeline(cfg, device="cpu").host_batch(5)
            jpart = jdata.SyntheticTokenPipeline(jdata.DataConfig(**kw, n_hosts=hosts,
                                                                  host_id=h)).host_batch(5)
            np.testing.assert_array_equal(np.asarray(jpart["tokens"]), part["tokens"].numpy())
            slices.append(part["tokens"])
        np.testing.assert_array_equal(torch.cat(slices).numpy(), out.global_batch(5)["tokens"])
        it = iter(out)
        np.testing.assert_array_equal(next(it)["labels"].numpy(), out.host_batch(0)["labels"])
    if source == "markov":
        assert out.source.entropy_per_token() == ref.source.entropy_per_token()
        np.testing.assert_array_equal(np.asarray(ref.source.successors),
                                      out.source.successors.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        data.DataConfig(vocab_size=8, seq_len=4, global_batch=5, n_hosts=2).per_host


# --- the train step --------------------------------------------------------------


def test_n_micro_two_against_jax_and_the_full_batch():
    """Two microbatches into float32 accumulators (JAX's scan) and the
    tokens count restored; against the full batch the mean of the two
    means (every label counted) is the batch's mean."""
    jcfg, tcfg, values, model = _carried("granite3_8b")
    batch = _tokens(jcfg, 4, 16, 2)

    def jloss(v, b):
        return jlm.train_loss(v, jcfg, b)

    jl, jm, jg = jax.jit(lambda v, b: jstep._accumulated_grads(jloss, v, b, 2))(values, batch)
    model.requires_grad_(True)

    def tloss(m, b):
        return lm.train_loss(m, tcfg, b)

    tl, tm, tg = step._accumulated_grads(tloss, model, _torch(batch), 2)
    assert all(g.dtype == torch.float32 for g in tg.values())
    # measured: loss 9.5e-7, gradients 5.1e-5 (the largest 0.47)
    assert abs(float(tl) - float(jl)) <= 2e-6
    assert float(tm["tokens"]) == float(jm["tokens"]) == 64.0
    for k in ("ce_loss", "aux_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 2e-6, k
    diff, scale = _max_diff_tree(jg, tg)
    assert diff <= 5e-4 * scale, (diff, scale)
    fl, fm, fg = step._accumulated_grads(tloss, model, _torch(batch), 1)
    assert next(iter(fg.values())).dtype == torch.float32  # the parameters' dtype
    # measured: loss 4.8e-7, gradients 6.3e-8 relative to the largest
    assert abs(float(fl) - float(tl)) <= 2e-6 and float(fm["tokens"]) == 64.0
    worst = max(float((fg[n] - tg[n]).abs().max()) for n in tg)
    assert worst <= 1e-6 * max(float(g.abs().max()) for g in tg.values())


def test_remat_changes_no_value():
    """Train mode's per-block checkpoint recomputes each block in the
    backward pass; the gradients are those without it, bit for bit."""
    cfg = configs.get_smoke_config("hymba_1p5b")
    batch = _torch(_tokens(cfg, 2, 12, 4))
    grads = {}
    for policy in ("none", "nothing", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        model = lm.init_lm(c, seed=3, device="cpu").requires_grad_(True)
        loss, _ = lm.train_loss(model, c, batch)
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
    for policy in ("nothing", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[policy]))


def test_train_step_matches_jax():
    """Two steps of the cosine-scheduled AdamW with ``n_micro = 2``."""
    jcfg, tcfg, values, model = _carried("granite3_8b", seed=2)
    sched = (lambda s: jschedule.cosine_schedule(s, 1, 4))
    jfn = jax.jit(jstep.make_train_step(jcfg, None, jadamw.AdamWConfig(lr=1e-3), sched,
                                        jstep.TrainStepConfig(n_micro=2)))
    tfn = step.make_train_step(tcfg, None, adamw.AdamWConfig(lr=1e-3),
                               lambda s: schedule.cosine_schedule(s, 1, 4),
                               step.TrainStepConfig(n_micro=2))
    jopt = jadamw.adamw_init(values, jadamw.AdamWConfig(lr=1e-3))
    topt = adamw.adamw_init(model)
    for t in range(2):
        batch = _tokens(jcfg, 4, 8, 10 + t)
        values, jopt, jm = jfn(values, jopt, batch)
        model, topt, tm = tfn(model, topt, _torch(batch))
        # measured: loss 9.5e-7, grad norm 3.7e-5 relative (step 1: 1.9e-4
        # of 5.2, the first step's parameter differences carried in),
        # parameters 3.2e-5 (up to 4.1): Adam's first steps scale each
        # gradient by its own root mean square, so a near-zero gradient's
        # rounding moves its parameter by up to lr
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 5e-6
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert float(tm["lr"]) == float(jm["lr"])
        diff, _ = _max_diff_tree(values, dict(model.named_parameters()))
        assert diff <= 1e-4, diff


def test_compress_pods_and_mesh_refuse():
    """compress_pods without a mesh, or over a mesh with no "pod" axis,
    raises ValueError as the reference does (training/step.py:118); a
    mesh without compress_pods builds a step (held on ranks in
    tests/test_torch_mesh_lm.py)."""
    from repro_torch.distributed.sharding import AbstractMesh

    cfg = configs.get_smoke_config("granite3_8b")
    jcfg = jconfigs.get_smoke_config("granite3_8b")
    compress = step.TrainStepConfig(compress_pods=True)
    for mesh in (None, AbstractMesh((2, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="compress_pods requires a mesh with a 'pod' axis"):
            step.make_train_step(cfg, step_cfg=compress, mesh=mesh)
    with pytest.raises(ValueError, match="compress_pods requires a mesh with a 'pod' axis"):
        jstep.make_train_step(jcfg, None, step_cfg=compress)
    assert callable(step.make_train_step(cfg, mesh=AbstractMesh((2,), ("data",))))
