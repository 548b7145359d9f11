"""The port's training launcher against the JAX package's: ``run_training``
and ``main``, the run state's checkpoints, preemption and resume, the
fault-handling copies, and the decode-and-sample step
(``tests/test_substrates.py``, ``tests/test_system.py``).

The same inputs, made from a seed with numpy, go through the JAX
function and its port in float32 on the CPU.  Integer results (data
batches, tokens, step counts) are held exactly; floats within the
tolerance stated beside each check, the largest difference measured on
these inputs (jax 0.9.0, torch 2.13.0, CPU), rounded up.
"""

import dataclasses
import io
import re
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.training import step as jstep
from repro_torch import configs, convert, samplers
from repro_torch.data import pipeline as data
from repro_torch.distributed.fault import PreemptionHandler
from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.kernels.mh import ref as mref
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.samplers import chain_key
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


# --- the launcher --------------------------------------------------------------------


def test_run_training_losses_match_jax():
    """``run_training`` on JAX's initial weights: the same batches, the
    same schedule and AdamW, five steps with two microbatches."""
    jcfg, tcfg, _, model = _carried("granite3_8b", seed=0)
    kw = dict(steps=5, global_batch=4, seq_len=16, lr=1e-3, warmup=2, n_micro=2, log_every=100)
    with redirect_stdout(io.StringIO()):
        _, _, ref = jtrain.run_training(jtrain.TrainRun(cfg=jcfg, **kw))
        trained, opt, out = train.run_training(train.TrainRun(cfg=tcfg, device="cpu", **kw),
                                               model=model)
    # measured: 2.9e-6 at most (losses near 6.1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert int(opt["step"]) == 5 and trained is model


def test_preempt_resume_bit_exact(tmp_path):
    """tests/test_substrates.py:TestFaultTolerance on the port: 6 steps
    straight against 3 steps, a preemption, and a resumed run of 3, with
    tolerance 0 on the losses and the final weights and moments."""
    cfg = configs.get_smoke_config("granite3_8b")
    base = dict(cfg=cfg, global_batch=4, seq_len=16, lr=1e-3, ckpt_every=3, log_every=100,
                device="cpu")
    with redirect_stdout(io.StringIO()):
        ref_model, ref_opt, losses_ref = train.run_training(
            train.TrainRun(steps=6, ckpt_dir=str(tmp_path / "ref"), **base))
        handler = PreemptionHandler()
        orig = train.SyntheticTokenPipeline.host_batch
        calls = {"n": 0}

        def counting(self, step_):
            calls["n"] += 1
            if calls["n"] == 3:
                handler.simulate_preemption()
            return orig(self, step_)

        train.SyntheticTokenPipeline.host_batch = counting
        try:
            _, _, losses_a = train.run_training(
                train.TrainRun(steps=6, ckpt_dir=str(tmp_path / "ck"), **base),
                preemption=handler)
        finally:
            train.SyntheticTokenPipeline.host_batch = orig
        assert len(losses_a) == 3
        model_b, opt_b, losses_b = train.run_training(
            train.TrainRun(steps=6, ckpt_dir=str(tmp_path / "ck"), **base))
    assert losses_a + losses_b == losses_ref
    assert all(torch.equal(a, b) for a, b in zip(ref_model.parameters(), model_b.parameters()))
    for part in ("m", "v"):
        assert all(torch.equal(ref_opt[part][n], opt_b[part][n]) for n in ref_opt[part])
    assert int(opt_b["step"]) == 6


def _preempted_after(module, handler, n_batches):
    """``module``'s pipeline with a preemption requested as its
    ``n_batches``-th batch is drawn; restores it on exit."""
    orig = module.SyntheticTokenPipeline.host_batch
    calls = {"n": 0}

    def counting(self, step_):
        calls["n"] += 1
        if calls["n"] == n_batches:
            handler.simulate_preemption()
        return orig(self, step_)

    return counting, orig


def test_program_count_is_jax_jit_cache(tmp_path, monkeypatch):
    """One train program a batch signature, as JAX's ``jax.jit`` of the
    step keeps one: a run of fixed batch layout, preempted after two steps,
    and its resumed run each keep one program, and JAX's jit traces its
    step once in each.  The resumed JAX run's dispatch cache holds a second
    entry for the same trace: its restored state enters as numpy arrays
    (``restore_latest``), where the port writes it into its own tensors."""
    import types

    jitted, traces = [], []
    real_jit = jax.jit

    def jit(fn, *args, **kw):
        def traced(*a):
            traces.append(len(jitted) - 1)
            return fn(*a)

        jitted.append(real_jit(traced, *args, **kw))
        return jitted[-1]

    proxy = types.SimpleNamespace(**{n: getattr(jax, n) for n in dir(jax)
                                     if not n.startswith("__")})
    proxy.jit = jit
    monkeypatch.setattr(jtrain, "jax", proxy)
    programs, real_step = [], train.compiled_step

    def compiled_step(progs, *args):
        if not any(progs is p for p in programs):
            programs.append(progs)
        return real_step(progs, *args)

    monkeypatch.setattr(train, "compiled_step", compiled_step)
    jcfg = jconfigs.get_smoke_config("granite3_8b")
    tcfg = configs.get_smoke_config("granite3_8b")
    kw = dict(steps=4, global_batch=2, seq_len=8, log_every=100, ckpt_every=100)
    losses = {}
    for mod, cfg, extra in ((jtrain, jcfg, {}), (train, tcfg, {"device": "cpu"})):
        handler = PreemptionHandler()
        counting, orig = _preempted_after(mod, handler, 2)
        run = mod.TrainRun(cfg=cfg, ckpt_dir=str(tmp_path / mod.__name__), **kw, **extra)
        with redirect_stdout(io.StringIO()):
            monkeypatch.setattr(mod.SyntheticTokenPipeline, "host_batch", counting)
            first = mod.run_training(run, preemption=handler)[2]
            monkeypatch.setattr(mod.SyntheticTokenPipeline, "host_batch", orig)
            losses[mod] = (first, mod.run_training(run)[2])
    assert [len(a) for a in losses[train]] == [len(a) for a in losses[jtrain]] == [2, 2]
    assert traces == [0, 1]
    assert [len(p) for p in programs] == [traces.count(i) for i in range(len(jitted))] == [1, 1]
    assert [j._cache_size() for j in jitted] == [1, 2]
    assert all(list(p) == [train.TrainSignature(
        tokens=((2, 8), "int32"), labels=((2, 8), "int32"), image_embeds=None, frames=None,
        n_micro=1)] for p in programs)


def _pointers(model, opt_state) -> list[int]:
    return [t.data_ptr() for t in train.state_tensors(model, opt_state)]


@pytest.mark.parametrize("resumed", [False, True])
def test_state_is_written_in_place(tmp_path, monkeypatch, resumed):
    """``run_training`` trains the model's parameters and the AdamW state
    in their own tensors: after the steps (and, resumed, after
    ``load_state``) every parameter, the step counter and every moment is
    the tensor ``adamw_init`` saw before the first step."""
    cfg = configs.get_smoke_config("mamba2_1p3b")
    seen, real_init = [], train.adamw_init

    def adamw_init(model, *args):
        state = real_init(model, *args)
        seen.append((model, state, _pointers(model, state)))
        return state

    monkeypatch.setattr(train, "adamw_init", adamw_init)
    run = train.TrainRun(cfg=cfg, steps=3, global_batch=2, seq_len=8, log_every=100,
                         ckpt_every=2, ckpt_dir=str(tmp_path), device="cpu")
    with redirect_stdout(io.StringIO()):
        if resumed:
            train.run_training(dataclasses.replace(run, steps=2))
        model, opt, losses = train.run_training(run)
    (_, _, before), = seen[-1:]
    assert len(losses) == (1 if resumed else 3) and int(opt["step"]) == 3
    assert seen[-1][1] is opt and _pointers(model, opt) == before


def test_load_state_and_master_copies_keep_their_tensors():
    """``load_state`` copies a restored state into the state's own tensors
    (the step counter too), and ``adamw_update`` with master copies writes
    them in place and returns the state it was given."""
    cfg = configs.get_smoke_config("granite3_8b")
    model = lm.init_lm(cfg, seed=3, device="cpu")
    opt = adamw.adamw_init(model)
    tree = train.state_tree(lm.init_lm(cfg, seed=4, device="cpu"), adamw.adamw_init(model))
    tree["opt"]["step"] = torch.tensor(5, dtype=torch.int64)
    before = _pointers(model, opt)
    assert train.load_state(model, opt, tree) is opt
    assert _pointers(model, opt) == before and int(opt["step"]) == 5
    mcfg = adamw.AdamWConfig(use_master=True)
    opt = adamw.adamw_init(model, mcfg)
    grads = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    before = _pointers(model, opt)
    _, out, _ = adamw.adamw_update(grads, opt, model, mcfg, 1.0)
    assert out is opt and _pointers(model, opt) == before and int(opt["step"]) == 1
    assert all(torch.equal(opt["master"][n], p) for n, p in model.named_parameters())


def test_checkpoints_keep_no_generator_state():
    """The loss's checkpoints run with ``preserve_rng_state=False`` (a
    captured step cannot read the card's generator): no op of the loss
    draws a random number, so the loss and every gradient equal those of
    checkpoints that save and restore the generator, bit for bit."""
    from torch.utils import checkpoint as ckpt

    cfg = configs.get_smoke_config("hymba_1p5b")
    model = lm.init_lm(cfg, seed=2, device="cpu").requires_grad_(True)
    rows = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def loss_and_grads():
        loss, _ = lm.train_loss(model, cfg, batch)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    calls = []

    def preserving(fn, *args, **kw):
        calls.append(kw.pop("preserve_rng_state"))
        return ckpt.checkpoint(fn, *args, preserve_rng_state=True, **kw)

    loss, grads = loss_and_grads()
    real = lm.checkpoint
    lm.checkpoint = preserving
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        lm.checkpoint = real
    assert calls and not any(calls)
    assert torch.equal(loss, loss_p) and all(map(torch.equal, grads, grads_p))


def test_checkpoint_layout_is_jax(tmp_path):
    """The run state is the JAX launcher's tree: the JAX package restores
    the port's checkpoint into its own state's structure, leaf for leaf,
    bfloat16 parameters included."""
    from repro.checkpoint import CheckpointConfig as JConfig
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("whisper_large_v3"),
                               param_dtype_str="bfloat16")
    tcfg = dataclasses.replace(configs.get_smoke_config("whisper_large_v3"),
                               param_dtype_str="bfloat16")
    model = lm.init_lm(tcfg, seed=4, device="cpu")
    opt = adamw.adamw_init(model)
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    manager = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))
    manager.save(7, train.state_tree(model, opt))
    manager.wait()
    jvals, _ = jlm.init_lm_values(jax.random.PRNGKey(0), jcfg)
    like = {"params": jvals, "opt": jadamw.adamw_init(jvals)}
    restored, at = JManager(JConfig(directory=str(tmp_path))).restore_latest(like)
    assert at == 7 and int(restored["opt"]["step"]) == 7
    back = jax.tree.map(lambda a: np.asarray(a).view(np.int16) if np.asarray(a).dtype.kind == "V"
                        else np.asarray(a), restored["params"])
    mine = convert.named_to_tree({n: p.detach().view(torch.int16).numpy()
                                  for n, p in model.named_parameters()})
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_m]
    for (path, a), (_, b) in zip(flat_b, flat_m):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # and back into the port
    fresh = lm.init_lm(tcfg, seed=5, device="cpu")
    fopt = adamw.adamw_init(fresh)
    tree, at = manager.restore_latest(train.state_tree(fresh, fopt), device="cpu")
    train.load_state(fresh, fopt, tree)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    assert int(fopt["step"]) == 7


class TestFaultTolerance:
    """tests/test_substrates.py:TestFaultTolerance and TestStraggler on the
    port's copies."""

    def test_preemption_flag(self):
        h = PreemptionHandler()
        assert not h.preemption_requested
        h.simulate_preemption()
        assert h.preemption_requested
        h.clear()
        assert not h.preemption_requested

    def test_signal_requests_a_checkpoint(self):
        import os
        import signal

        h = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert h.preemption_requested
        finally:
            h.uninstall()
        assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL

    def test_flags_slow_host(self):
        flagged = []
        wd = StragglerWatchdog(n_hosts=4, threshold=1.5, min_steps=3,
                               on_flag=lambda h, e, m: flagged.append(h))
        for _ in range(6):
            for h in range(4):
                wd.record(h, 1.0 if h != 2 else 3.0)
            wd.check()
        assert wd.flagged == [2] and flagged == [2]

    def test_global_slowdown_flags_nobody(self):
        wd = StragglerWatchdog(n_hosts=4, min_steps=2)
        for t in (1.0, 2.0, 4.0):
            for h in range(4):
                wd.record(h, t)
            wd.check()
        assert wd.flagged == []

    def test_recovery_unflags(self):
        wd = StragglerWatchdog(n_hosts=2, min_steps=2, ema_alpha=1.0)
        for _ in range(4):
            wd.record(0, 1.0)
            wd.record(1, 5.0)
        wd.check()
        assert wd.flagged == [1]
        for _ in range(4):
            wd.record(0, 1.0)
            wd.record(1, 1.0)
        wd.check()
        assert wd.flagged == []


def _masked(text: str) -> list[str]:
    """The printed lines with every number replaced by '#'."""
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line) for line in text.splitlines()]


def test_main_prints_the_jax_format(monkeypatch):
    argv = ["--arch", "mamba2_1p3b", "--smoke", "--steps", "3", "--batch", "2", "--seq", "8"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with redirect_stdout(io.StringIO()) as jout:
        jtrain.main()
    with redirect_stdout(io.StringIO()) as tout:
        row = train.main([*argv, "--device", "cpu"])
    assert _masked(tout.getvalue()) == _masked(jout.getvalue())
    assert tout.getvalue().startswith("[train] step     0 loss ")
    assert len(row["losses"]) == 3 and int(row["opt_state"]["step"]) == 3
    assert not any(p.requires_grad is False for p in row["model"].parameters())


def test_train_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite3_8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.SyntheticTokenPipeline(data.DataConfig(vocab_size=8, seq_len=4, global_batch=1))


# --- the decode-and-sample step -------------------------------------------------------


def _mcmc_margin(key, logits, init, cfg) -> tuple[int, float]:
    """(tie events, least accept margin) of the chain the sampler runs on
    ``logits`` (B, V) from ``init`` (B,) in one chunk
    (``tests/test_torch_serve.py``): a logit difference below half the
    margin changes no accept decision."""
    eng = samplers.MHEngine(cfg.engine_config(), device="cpu")
    table = logits / torch.full_like(logits, cfg.temperature)
    init = init.long()[:, None]
    flips, u = eng.randomness.chunk(chain_key(eng._key(key), 0), 0, cfg.n_steps,
                                    tuple(init.shape), cfg.nbits)
    return (len(mref.tie_events(table, init, flips, u, cfg.nbits)),
            mref.accept_margin(table, init, flips, u, cfg.nbits))


@partitionable
def test_decode_sample_step_tokens_equal_jax():
    """``make_decode_sample_step`` on carried weights after a prefill, 3
    steps: the tokens equal JAX's, each step checked to have no accept
    decision within the logit difference (ROADMAP.md queue 3 item 2)."""
    jcfg, tcfg, values, model = _carried("granite3_8b", seed=6)
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = jlm.prefill(values, jcfg, {"tokens": prompt}, jlm.init_cache(jcfg, 2, 12))[1]
    tcache = lm.prefill(model, tcfg, {"tokens": torch.from_numpy(prompt)},
                        lm.init_cache(tcfg, 2, 12, device="cpu"))[1]
    jfn, tfn = jstep.make_decode_sample_step(jcfg), step.make_decode_sample_step(tcfg)
    tokens, jkey, v = prompt[:, -1:], jax.random.PRNGKey(9), jcfg.vocab_size
    for t in range(3):
        jkey, sub = jax.random.split(jkey)
        jlogits = np.asarray(jlm.decode_step(values, jcfg, tokens, jcache)[0])[:, :v]
        ref_tok, jcache, ref_acc = jfn(values, tokens, jcache, sub)
        key = convert.key_from_numpy(np.asarray(sub), device="cpu")
        # the logits alone first: writing this token's K/V twice at one index
        # leaves the cache as one write does
        tlogits = lm.decode_step(model, tcfg, torch.from_numpy(tokens), dict(tcache))[0][:, :v]
        out_tok, tcache, acc = tfn(model, torch.from_numpy(tokens), tcache, key)
        diff = float(np.abs(jlogits - tlogits.numpy()).max())
        ties, margin = _mcmc_margin(key, tlogits, torch.from_numpy(tokens[:, 0]),
                                    step.token_sampler.TokenSamplerConfig(vocab_size=v,
                                                                          n_steps=32))
        # measured: logits 7.3e-6 apart at most
        assert diff < 2e-5 and ties == 0 and margin > 2 * diff, (
            "a near tie: replace the seed", diff, ties, margin)
        np.testing.assert_array_equal(np.asarray(ref_tok), out_tok.numpy())
        assert float(acc) == pytest.approx(float(ref_acc), abs=0)
        tokens = np.array(ref_tok)
    assert out_tok.dtype == torch.int32 and int(tcache["index"]) == 9
