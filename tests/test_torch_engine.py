"""The port's MH engine against the JAX package, at tolerance 0.

The grid is {host, cim, fused} x {scan, pallas} x {all, thin:3, last} x
num_chains {1, 3} x step0.  For each backend the JAX engine's Pallas
executor (interpret mode) is jitted once with a traced ``step0`` and run
for three chains with ``collect="all"`` as one chunk; the port runs each
cell in chunks of 5 steps.  The port's cells are held against that run
through the JAX package's own contracts: chain c of a C-chain run equals
a solo run with ``chain_id=c``; ``thin:k`` keeps the absolute steps
``(step0 + t) % k == 0`` of the ``all`` stream; ``last`` keeps its final
carry.  On the CPU the port's ``pallas`` executor runs the kernels'
plain versions.

Under ``jit`` XLA may turn ``acceptance_rate``'s division by a constant
into a reciprocal multiply, one ULP off; the JAX package's default eager
submit divides, as the port does, so the rate is held against
``float32(sum) / float32(total)`` here and against eager JAX runs in
``test_sample_tokens``.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro_torch import convert, prng
from repro_torch import samplers as ts
from repro_torch.kernels.mh import mh, ref

ROOT = Path(__file__).resolve().parents[1]
B, V, C, N = 2, 45, 4, 13
CHAINS = 3
SEED = 17

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)


def _data():
    rs = np.random.default_rng(SEED)
    table = (rs.normal(size=(B, V)) * 2).astype(np.float32)
    init = rs.integers(0, V, size=(CHAINS, B, C)).astype(np.uint32)
    return table, init


def _cfg(randomness, **kw):
    return dict(randomness=randomness, chunk_steps=5, p_bfr=0.4, **kw)


def _no_ties(randomness, step0):
    """Replay every chain of the reference run with the port's operands
    and assert no step is a tie event (the parity contract's only
    exception)."""
    table, init = _data()
    cfg = ts.EngineConfig(**_cfg(randomness))
    backend = cfg.backend()
    keys = ts.chain_keys(prng.PRNGKey(SEED), CHAINS)
    nbits = ts.TableTarget(torch.from_numpy(table)).nbits
    for c in range(CHAINS):
        flips, u = backend.chunk(keys[c], step0, N, (B, C), nbits)
        ties = ref.tie_events(
            torch.from_numpy(table), torch.from_numpy(init[c].astype(np.int64)),
            flips, u, nbits,
        )
        assert ties.shape[0] == 0, f"tie events {ties.tolist()} in chain {c}"


COLLECTS = ("all", "thin:3", "last")
FIELDS = ("samples", "accept_count", "final_words", "final_logp")


@pytest.fixture(scope="module")
def jax_runs():
    """One 3-chain JAX run per (backend, step0), collect="all"."""
    table, init = _data()
    target = js.TableTarget(table)
    runs = {}
    for randomness in ("host", "cim", "fused"):
        eng = js.MHEngine(
            js.EngineConfig(
                randomness=randomness, p_bfr=0.4, execution="pallas",
                num_chains=CHAINS, chunk_steps=1000,
            )
        )
        run = jax.jit(
            lambda w, s, eng=eng: eng.run(jax.random.PRNGKey(SEED), target, N, w, step0=s)
        )
        for step0 in (0, 7):
            _no_ties(randomness, step0)
            res = run(init, step0)
            runs[randomness, step0] = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    return runs


def _kept(samples, collect, step0):
    """The JAX package's kept set, from its "all" stream (time axis 1)."""
    mode, k = js.parse_collect(collect)
    if mode == "all":
        return samples
    if mode == "thin":
        return samples[:, (-step0) % k::k]
    return samples[:, :0]


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("collect", COLLECTS)
@pytest.mark.parametrize("num_chains", [1, 3])
@pytest.mark.parametrize("step0", [0, 7])
def test_engine_grid(jax_runs, randomness, execution, collect, num_chains, step0):
    _check_cell(jax_runs, randomness, execution, collect, num_chains, step0)


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
@pytest.mark.parametrize("collect", ["all", "last"])
@pytest.mark.parametrize("num_chains", [1, 3])
def test_tensor_step0_equals_jax(jax_runs, randomness, execution, collect, num_chains):
    """A 0-d int64 tensor ``step0`` (JAX's traced offset) runs the int
    offset's stream on both executors, the kernels' plain versions too."""
    _check_cell(jax_runs, randomness, execution, collect, num_chains, 7, tensor_step0=True)


def test_tensor_step0_refuses_thin():
    """``thin:<k>``'s kept count is a shape: a tensor ``step0`` raises."""
    table, init = _data()
    for execution in ("scan", "pallas"):
        eng = ts.MHEngine(ts.EngineConfig(execution=execution, collect="thin:3"),
                          device="cpu")
        with pytest.raises(ValueError, match="int step0"):
            eng.run(prng.PRNGKey(SEED), ts.TableTarget(torch.from_numpy(table)), N, init[0],
                    step0=torch.tensor(7))


def _check_cell(jax_runs, randomness, execution, collect, num_chains, step0,
                tensor_step0=False):
    table, init = _data()
    want = dict(jax_runs[randomness, step0])
    want["samples"] = _kept(want["samples"], collect, step0)
    eng = ts.MHEngine(
        ts.EngineConfig(
            **_cfg(randomness, execution=execution, num_chains=num_chains, collect=collect)
        ),
        device="cpu",
    )
    chain = slice(None) if num_chains == 3 else 1
    h = eng.submit(
        ts.RunPlan(
            target=ts.TableTarget(torch.from_numpy(table)), n_steps=N,
            init_words=init if num_chains == 3 else init[1], seed=SEED,
            step0=torch.tensor(step0) if tensor_step0 else step0,
            chain_id=0 if num_chains == 3 else 1,
        )
    )
    got = convert.result_to_numpy(h.result)
    for f in FIELDS:  # JAX's multi-chain fields are chain-major
        np.testing.assert_array_equal(got[f], want[f][chain])
    acc = want["accept_count"][chain]
    assert got["acceptance_rate"] == np.float32(acc.sum()) / (
        np.float32(N) * np.float32(acc.size)
    )
    assert got["n_steps"] == N


@partitionable
@pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_resume_is_bit_exact(randomness, execution):
    table, init = _data()
    eng = ts.MHEngine(ts.EngineConfig(**_cfg(randomness, execution=execution)), device="cpu")
    plan = ts.RunPlan(
        target=ts.TableTarget(torch.from_numpy(table)), n_steps=N, init_words=init[0], seed=5
    )
    full = eng.submit(plan)
    first = eng.submit(plan.replace(n_steps=6))
    assert (first.resume_plan(7).init_logp is not None) == (execution == "scan")
    second = first.resume(7)
    assert second.progress == N
    assert torch.equal(torch.cat([first.samples, second.samples]), full.samples)
    for f in ("final_words", "final_logp"):
        assert torch.equal(getattr(second, f), getattr(full, f))
    assert torch.equal(first.accept_count + second.accept_count, full.accept_count)


@partitionable
def test_sample_tokens():
    rs = np.random.default_rng(2)
    logits = (rs.normal(size=(3, 50)) * 3).astype(np.float32)
    logits[1, [4, 9, 31]] = 9.0  # a tied top row
    init = np.array([0, 49, -1], np.int32)
    cfg = _cfg("host", execution="pallas")
    jeng = js.MHEngine(js.EngineConfig(**cfg))
    teng = ts.MHEngine(ts.EngineConfig(**cfg), device="cpu")
    key = np.asarray(jax.random.PRNGKey(4))
    for kw in (dict(), dict(top_k=3, temperature=0.8), dict(init_tokens=init)):
        jtok, jres = jeng.sample_tokens(
            jax.numpy.asarray(key), logits, 12,
            **{k: (jax.numpy.asarray(v) if k == "init_tokens" else v) for k, v in kw.items()},
        )
        ttok, tres = teng.sample_tokens(
            convert.key_from_numpy(key, device="cpu"), torch.from_numpy(logits), 12,
            **{k: (torch.from_numpy(v) if k == "init_tokens" else v) for k, v in kw.items()},
        )
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        assert ttok.dtype == torch.int32
        got = convert.result_to_numpy(tres)
        for f in ("samples", "accept_count", "final_words", "final_logp", "acceptance_rate"):
            np.testing.assert_array_equal(np.asarray(getattr(jres, f)), got[f])


def test_execution_resolution():
    table = ts.TableTarget(torch.zeros(1, 4))
    fn = ts.CallableTarget(lambda w: w.to(torch.float32), nbits=2)
    assert ts.resolve_execution("auto", table, "cpu") == "scan"
    assert ts.resolve_execution("auto", table, "cuda") == "pallas"
    assert ts.resolve_execution("auto", fn, "cuda") == "scan"
    assert ts.resolve_execution("pallas", table, "cpu") == "pallas"
    with pytest.raises(ValueError):
        ts.resolve_execution("pallas", fn, "cpu")


def test_callable_target_scan():
    eng = ts.MHEngine(ts.EngineConfig(randomness="fused"), device="cpu")
    target = ts.CallableTarget(lambda w: -0.1 * w.to(torch.float32), nbits=5)
    res = eng.run(prng.PRNGKey(0), target, 9, torch.zeros(2, 3, 2, dtype=torch.int64))
    assert res.samples.shape == (9, 2, 3, 2)
    assert torch.equal(res.final_logp, target.log_prob(res.final_words))


def test_engine_device_rule():
    """No device means the card; without one the engine raises rather
    than move to the CPU."""
    if torch.cuda.is_available():
        assert ts.MHEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.MHEngine()
    eng = ts.MHEngine(device="cpu")
    assert eng.device.type == "cpu"


def test_convert_device_rule():
    """The converters follow the engine's rule: no device means the card,
    and the CPU only when asked for."""
    key, table, words = np.array([1, 2], np.uint32), np.zeros((2, 3)), np.ones((2, 4))
    convs = (
        (convert.key_from_numpy, key),
        (convert.table_from_numpy, table),
        (convert.words_from_numpy, words),
    )
    for conv, x in convs:
        assert conv(x, device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert conv(x).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                conv(x)


def test_save_writes_a_checkpoint(tmp_path):
    """``RunHandle.save`` writes the resume carry at the handle's step, in
    the JAX package's dtypes, with the plan's fingerprint."""
    from repro_torch.checkpoint import latest_step, load_checkpoint_tree

    eng = ts.MHEngine(device="cpu")
    table, init = _data()
    plan = ts.RunPlan(
        target=ts.TableTarget(torch.from_numpy(table)), n_steps=2, init_words=init[0], seed=0,
        step0=3,
    )
    handle = eng.submit(plan)
    path = handle.save(str(tmp_path))
    assert latest_step(str(tmp_path)) == 5 and path.endswith("step_00000005")
    tree, manifest = load_checkpoint_tree(str(tmp_path), 5)
    assert manifest["extra"]["fingerprint"] == plan.fingerprint(eng)
    assert [e["dtype"] for e in manifest["leaves"]] == ["int32", "float32", "uint32"]
    np.testing.assert_array_equal(tree["words"], handle.final_words.numpy())
    np.testing.assert_array_equal(tree["logp"], handle.final_logp.numpy())


def test_solo_run_ignores_mesh():
    """A solo run (num_chains == 1) never reads ``mesh``, as in JAX; a
    multi-chain run with a mesh object that is not a DeviceMesh fails."""
    eng = ts.MHEngine(device="cpu")
    table, init = _data()
    plan = ts.RunPlan(
        target=ts.TableTarget(torch.from_numpy(table)), n_steps=2, init_words=init[0], seed=0
    )
    a, b = eng.submit(plan).result, eng.submit(plan.replace(mesh=object())).result
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    multi = ts.MHEngine(ts.EngineConfig(num_chains=CHAINS), device="cpu")
    with pytest.raises(AttributeError):
        multi.submit(plan.replace(init_words=init, mesh=object()))


def test_validation():
    table, init = _data()
    target = ts.TableTarget(torch.from_numpy(table))
    with pytest.raises(ValueError):
        ts.RunPlan(target=target, n_steps=2, init_words=init[0])  # no key or seed
    with pytest.raises(ValueError):
        ts.RunPlan(target=target, n_steps=0, init_words=init[0], seed=1)
    with pytest.raises(ValueError):
        ts.EngineConfig(collect="thin:0")
    multi = ts.MHEngine(ts.EngineConfig(num_chains=3), device="cpu")
    with pytest.raises(ValueError, match="leading"):
        multi.submit(ts.RunPlan(target=target, n_steps=2, init_words=init[0], seed=1))
    pallas = ts.MHEngine(ts.EngineConfig(execution="pallas"), device="cpu")
    with pytest.raises(ValueError, match="init_logp"):
        pallas.run(prng.PRNGKey(0), target, 2, init[0], init_logp=torch.zeros(B, C))


def test_config_dict_builds_both_engines():
    cfg = dict(randomness="fused", chunk_steps=9, num_chains=2, collect="thin:4")
    jcfg = js.EngineConfig(**cfg)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    plan = ts.RunPlan(target=ts.TableTarget(torch.zeros(1, 4)), n_steps=3, init_words=np.zeros((2, 1, 2)), seed=3)
    fp = plan.fingerprint(ts.MHEngine(tcfg, device="cpu"))
    assert fp["key"] == [0, 3] and fp["state_shape"] == [2, 1, 2] and fp["collect"] == "thin:4"


def test_kernel_launch_counts_stay_zero_on_cpu():
    mh.reset_launches()
    table, init = _data()
    eng = ts.MHEngine(ts.EngineConfig(execution="pallas"), device="cpu")
    eng.submit(ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=3, init_words=init[0], seed=1))
    assert mh.LAUNCHES == {"mh_chain": 0, "mh_chain_fused": 0}


def test_port_imports_no_jax():
    """The port, its chip check and the card's tools import neither jax nor
    the JAX package."""
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    for needed in ("optim/adamw.py", "optim/schedule.py", "data/pipeline.py",
                   "training/step.py", "launch/train.py", "distributed/fault.py",
                   "distributed/straggler.py"):
        assert port / needed in files, needed
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
