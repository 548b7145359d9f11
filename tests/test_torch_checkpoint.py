"""The port's checkpoints and resumable runs: segmented + checkpointed
equals unsegmented word for word across {mh, gibbs} x {host, cim,
fused}, with kill and restart, fingerprint refusal and the collection
axis (the port of ``tests/test_checkpoint.py``); and the on-disk format
against the JAX package's — the same manifest keys, shapes and dtypes
for the same tree, the same fingerprint, and checkpoints that cross
between the packages both ways.

Runs that are compared with the JAX package assert that their draws
hold no tie event (``kernels/mh/ref.py:tie_events``), the parity
contract's one exception.
"""

import collections
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as js
from repro.checkpoint import load_checkpoint_tree as jax_load_tree
from repro.checkpoint import run_resumable as jax_run_resumable
from repro.checkpoint import save_checkpoint as jax_save
from repro.samplers.plan import fingerprint_digest as jax_digest
from repro_torch import prng, telemetry, workloads
from repro_torch import samplers as ts
from repro_torch.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    load_checkpoint_tree,
    run_resumable,
    save_checkpoint,
)
from repro_torch.kernels.mh import ref
from repro_torch.samplers.plan import fingerprint_digest
from repro_torch.workloads.ising import IsingModel

FIELDS = ("samples", "accept_count", "acceptance_rate", "final_words", "final_logp")


@pytest.fixture(autouse=True)
def _telemetry_off():
    yield
    telemetry.disable()
    telemetry.TRACER.reset()
    telemetry.REGISTRY.reset()


def _mh_data(seed=0):
    rs = np.random.default_rng(seed)
    table = rs.normal(size=(2, 64)).astype(np.float32)
    init = np.broadcast_to(np.argmax(table, -1).astype(np.uint32)[:, None], (2, 8)).copy()
    return table, init


def _mh_setup(seed=0):
    table, init = _mh_data(seed)
    return ts.TableTarget(torch.from_numpy(table)), init


def _gibbs_setup(seed=1):
    rs = np.random.default_rng(seed)
    return IsingModel(6, 6), rs.integers(0, 2, size=(2, 6, 6)).astype(np.uint32)


def _engine(**kw):
    return ts.MHEngine(ts.EngineConfig(**kw), device="cpu")


def _assert_bit_identical(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert got.n_steps == want.n_steps


class TestRoundTrip:
    @pytest.mark.parametrize("update", ["mh", "gibbs"])
    @pytest.mark.parametrize("randomness", ["host", "cim", "fused"])
    def test_segmented_equals_unsegmented(self, tmp_path, update, randomness):
        target, init = _gibbs_setup() if update == "gibbs" else _mh_setup()
        engine = _engine(update=update, randomness=randomness, chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=28, init_words=init, key=prng.PRNGKey(3))
        want = engine.submit(plan).result
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=10)
        _assert_bit_identical(handle.result, want)

    @pytest.mark.parametrize("collect", [None, "last"])
    def test_multi_chain_round_trip(self, tmp_path, collect):
        """Multi-chain results are chain-major (C, T, *state): segment
        streams concatenate on the time axis, not the chain axis."""
        target, init = _mh_setup()
        engine = _engine(num_chains=4, chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=24, init_words=np.broadcast_to(init, (4, 2, 8)),
                          seed=6, collect=collect)
        want = engine.submit(plan).result
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        _assert_bit_identical(handle.result, want)

    @pytest.mark.parametrize("collect", ["thin:4", "last"])
    def test_collection_axis_round_trip(self, tmp_path, collect):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8, collect=collect)
        plan = ts.RunPlan(target=target, n_steps=24, init_words=init, key=prng.PRNGKey(4))
        want = engine.submit(plan).result
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        _assert_bit_identical(handle.result, want)

    def test_pallas_executor_round_trip(self, tmp_path):
        """The kernel executor (its plain versions on the CPU), multi-chain
        Gibbs under ``thin``: the paths the card's resume runs."""
        model, init = _gibbs_setup()
        engine = _engine(update="gibbs", randomness="fused", execution="pallas", num_chains=3,
                         chunk_steps=4, collect="thin:3")
        plan = ts.RunPlan(target=model, n_steps=20, init_words=np.stack([init] * 3), seed=9)
        want = engine.submit(plan).result
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=7)
        _assert_bit_identical(handle.result, want)


class Die(RuntimeError):
    pass


class TestKillAndResume:
    @pytest.mark.parametrize("kill_after", [1, 2, 3])
    def test_killed_run_resumes_bit_exactly(self, tmp_path, kill_after):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=32, init_words=init, key=prng.PRNGKey(7))
        want = engine.submit(plan).result

        def die(done, total, handle):
            if done >= 8 * kill_after:
                raise Die

        with pytest.raises(Die):
            run_resumable(engine, plan, directory=str(tmp_path), every=8, on_segment=die)
        # the kill landed after the checkpoint of that segment committed
        assert latest_step(str(tmp_path)) == 8 * kill_after
        handle = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        _assert_bit_identical(handle.result, want)

    def test_resume_under_retuned_engine(self, tmp_path):
        """chunk_steps/execution are outside the fingerprint: a run
        checkpointed under one tuning resumes bit-exactly under another."""
        target, init = _mh_setup()
        a = _engine(chunk_steps=8)
        b = _engine(chunk_steps=16, execution="pallas")
        plan = ts.RunPlan(target=target, n_steps=24, init_words=init, key=prng.PRNGKey(8))
        want = a.submit(plan).result

        def die_once(done, total, handle):
            if done >= 8:
                raise Die

        with pytest.raises(Die):
            run_resumable(a, plan, directory=str(tmp_path), every=8, on_segment=die_once)
        handle = run_resumable(b, plan, directory=str(tmp_path), every=8)
        _assert_bit_identical(handle.result, want)

    def test_completed_run_replays_from_checkpoint(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=16, init_words=init, seed=5)
        first = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        again = run_resumable(engine, plan, directory=str(tmp_path), every=8)
        _assert_bit_identical(again.result, first.result)


class TestFingerprint:
    def test_mismatched_stream_refused(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=16, init_words=init, seed=0)
        run_resumable(engine, plan, directory=str(tmp_path), every=8)
        with pytest.raises(ValueError, match="different run"):
            run_resumable(engine, plan.replace(seed=1), directory=str(tmp_path), every=8)

    def test_mismatched_engine_axes_refused(self, tmp_path):
        target, init = _mh_setup()
        plan = ts.RunPlan(target=target, n_steps=16, init_words=init, seed=0)
        run_resumable(_engine(randomness="cim"), plan, directory=str(tmp_path), every=8)
        with pytest.raises(ValueError, match="different run"):
            run_resumable(_engine(randomness="host"), plan, directory=str(tmp_path), every=8)

    def test_handle_save_records_fingerprint(self, tmp_path):
        target, init = _mh_setup()
        engine = _engine(chunk_steps=8)
        plan = ts.RunPlan(target=target, n_steps=8, init_words=init, seed=2)
        handle = engine.submit(plan)
        path = handle.save(str(tmp_path))
        assert path == os.path.join(str(tmp_path), "step_00000008")
        tree, manifest = load_checkpoint_tree(str(tmp_path), handle.progress)
        assert manifest["extra"]["fingerprint"] == plan.fingerprint(engine)
        np.testing.assert_array_equal(tree["words"], handle.final_words.numpy())
        np.testing.assert_array_equal(tree["acc"], handle.accept_count.numpy())
        assert {k: v.dtype for k, v in tree.items()} == {
            "acc": np.int32, "logp": np.float32, "words": np.uint32}

    @pytest.mark.parametrize("update,randomness,num_chains,collect", [
        ("mh", "cim", 1, None), ("mh", "fused", 3, "thin:2"), ("gibbs", "host", 1, "last"),
    ])
    def test_fingerprint_and_digest_equal_jax(self, update, randomness, num_chains, collect):
        if update == "mh":
            table, init = _mh_data()
            jt, tt = js.TableTarget(jnp.asarray(table)), ts.TableTarget(torch.from_numpy(table))
        else:
            from repro.workloads.ising import IsingModel as JaxIsing

            (tt, init), jt = _gibbs_setup(), JaxIsing(6, 6)
        if num_chains > 1:
            init = np.stack([init] * num_chains)
        cfg = dict(update=update, randomness=randomness, num_chains=num_chains, p_bfr=0.4)
        jplan = js.RunPlan(target=jt, n_steps=5, init_words=jnp.asarray(init), seed=2**31 + 5,
                           chain_id=2, collect=collect)
        tplan = ts.RunPlan(target=tt, n_steps=5, init_words=init, seed=2**31 + 5, chain_id=2,
                           collect=collect)
        jfp = jplan.fingerprint(js.MHEngine(js.EngineConfig(**cfg)))
        tfp = tplan.fingerprint(_engine(**cfg))
        assert tfp == jfp
        assert fingerprint_digest(tfp) == jax_digest(jfp)
        assert json.dumps(tfp, sort_keys=True) == json.dumps(jfp, sort_keys=True)


NT = collections.namedtuple("NT", "a b")


@dataclasses.dataclass
class _Leaves:
    x: object
    y: object


class TestFormat:
    def _tree(self):
        rs = np.random.default_rng(5)
        return {
            "z": rs.normal(size=(3,)).astype(np.float32),
            "a": [rs.integers(0, 9, (2, 2)).astype(np.int32),
                  (np.uint32(7), {"q": np.arange(4, dtype=np.int64), "b": np.float32(1.5)})],
            "n": None,
            "nt": NT(np.zeros((1, 2), np.uint8), np.ones(3, np.float64)),
        }

    def test_manifest_equals_jax(self, tmp_path):
        """The same tree gives the same leaf keys, files, shapes, dtypes and
        hashes, in the same order, as the JAX package writes."""
        tree = self._tree()
        jax_save(str(tmp_path / "jax"), 3, tree, extra={"k": 1})
        save_checkpoint(str(tmp_path / "port"), 3, tree, extra={"k": 1})
        manifests = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
                     for d in ("jax", "port")]
        assert manifests[0]["leaves"] == manifests[1]["leaves"]
        assert [e["key"] for e in manifests[1]["leaves"]] == [
            "a/0", "a/1/0", "a/1/1/b", "a/1/1/q", "nt/.a", "nt/.b", "z"]
        assert manifests[0]["step"] == manifests[1]["step"] == 3
        assert manifests[0]["extra"] == manifests[1]["extra"] == {"k": 1}

    def test_tensor_tree_round_trip(self, tmp_path):
        tree = {"w": torch.arange(6, dtype=torch.int64).reshape(2, 3),
                "d": _Leaves(x=torch.ones(2), y=[torch.zeros(1, dtype=torch.int32)]),
                "t": (torch.tensor(2.5),)}
        save_checkpoint(str(tmp_path), 1, tree)
        host, manifest = load_checkpoint(str(tmp_path), 1, tree)
        assert [e["key"] for e in manifest["leaves"]] == ["d/.x", "d/.y/0", "t/0", "w"]
        assert isinstance(host["w"], np.ndarray) and isinstance(host["d"], _Leaves)
        back, _ = load_checkpoint(str(tmp_path), 1, tree, device="cpu")
        assert torch.equal(back["w"], tree["w"]) and torch.equal(back["d"].x, tree["d"].x)
        assert isinstance(back["t"], tuple) and torch.equal(back["t"][0], tree["t"][0])

    def test_uint32_words_widen_on_load(self, tmp_path):
        words = np.array([[0, 2**32 - 1], [2**31, 5]], np.uint32)
        save_checkpoint(str(tmp_path), 2, {"words": words})
        back, _ = load_checkpoint(str(tmp_path), 2, {"words": torch.zeros(2, 2)}, device="cpu")
        assert back["words"].dtype == torch.int64
        assert back["words"].tolist() == words.astype(np.int64).tolist()

    def test_corrupted_leaf_refused(self, tmp_path):
        save_checkpoint(str(tmp_path), 4, {"x": np.arange(10, dtype=np.int32)})
        leaf = tmp_path / "step_00000004" / "leaf_00000.npy"
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 1
        leaf.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="integrity"):
            load_checkpoint_tree(str(tmp_path), 4, verify=True)
        with pytest.raises(IOError, match="integrity"):
            load_checkpoint(str(tmp_path), 4, {"x": np.zeros(10)})
        tree, _ = load_checkpoint_tree(str(tmp_path), 4, verify=False)
        assert tree["x"][-1] != 9

    def test_shape_mismatch_and_missing_leaf(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": np.zeros(3)})
        with pytest.raises(ValueError, match="mismatch"):
            load_checkpoint(str(tmp_path), 1, {"x": np.zeros(4)})
        with pytest.raises(KeyError, match="missing"):
            load_checkpoint(str(tmp_path), 1, {"y": np.zeros(3)})

    def test_save_is_idempotent_per_step(self, tmp_path):
        first = save_checkpoint(str(tmp_path), 5, {"x": np.zeros(2)})
        again = save_checkpoint(str(tmp_path), 5, {"x": np.ones(2)})
        assert first == again
        tree, _ = load_checkpoint_tree(str(tmp_path), 5)
        assert (tree["x"] == 0).all()
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


class TestManager:
    @pytest.mark.parametrize("async_save", [True, False])
    def test_retention_and_restore_latest(self, tmp_path, async_save):
        mgr = CheckpointManager(CheckpointConfig(str(tmp_path), retention=2,
                                                 async_save=async_save))
        like = {"w": torch.zeros(3, dtype=torch.int64)}
        assert mgr.restore_latest(like) == (None, None)
        for step in (1, 2, 3):
            mgr.save(step, {"w": torch.full((3,), step, dtype=torch.int64)})
        tree, step = mgr.restore_latest(like, device="cpu")
        assert step == 3 and tree["w"].tolist() == [3, 3, 3]
        assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]

    def test_async_save_copies_before_returning(self, tmp_path):
        """The host copy is taken on the caller's thread: a tensor written
        after ``save`` returns does not reach the checkpoint."""
        mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True))
        x = torch.zeros(1000, dtype=torch.int64)
        mgr.save(1, {"x": x})
        x += 7
        mgr.wait()
        tree, _ = load_checkpoint_tree(str(tmp_path), 1)
        assert (tree["x"] == 0).all()

    def test_async_error_surfaces_on_wait(self, tmp_path):
        mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True))
        mgr.save(1, {"x": np.array([object()])})  # not savable without pickle
        with pytest.raises(ValueError):
            mgr.wait()


class TestWorkloadResume:
    def test_workload_diagnostics_survive_resume(self, tmp_path):
        """The production recipe: a workload's RunPlan driven by
        run_resumable gives the direct run's result and diagnostics."""
        k_init, k_run = prng.split(prng.PRNGKey(0))
        wl = workloads.build("ising", k_init, smoke=True, backend="scan", device="cpu")
        want = wl.run(k_run)
        handle = run_resumable(wl.engine, wl.plan(k_run), directory=str(tmp_path), every=16)
        _assert_bit_identical(handle.result, want)
        assert wl.diagnostics(handle.result) == wl.diagnostics(want)


def _assert_no_ties(table, init, randomness, key, n_steps, nbits=6):
    backend = ts.EngineConfig(randomness=randomness).backend()
    flips, u = backend.chunk(ts.chain_key(key, 0), 0, n_steps, init.shape, nbits)
    ties = ref.tie_events(torch.from_numpy(table), torch.from_numpy(init.astype(np.int64)),
                          flips, u, nbits)
    assert ties.shape[0] == 0, f"tie events at {ties.tolist()}"


class TestAcrossPackages:
    @pytest.mark.parametrize("randomness", ["cim", "fused"])
    def test_port_finishes_a_jax_directory(self, tmp_path, randomness):
        """JAX's run_resumable raises in on_segment after two segments; the
        port's run_resumable finishes the directory, to JAX's unsegmented
        result."""
        table, init = _mh_data(1)
        _assert_no_ties(table, init, randomness, prng.PRNGKey(12), 32)
        jeng = js.MHEngine(js.EngineConfig(randomness=randomness, chunk_steps=8))
        jplan = js.RunPlan(target=js.TableTarget(jnp.asarray(table)), n_steps=32,
                           init_words=jnp.asarray(init), key=jax.random.PRNGKey(12),
                           collect="thin:3")
        want = jeng.submit(jplan).result

        def die(done, total, handle):
            if done >= 16:
                raise Die

        with pytest.raises(Die):
            jax_run_resumable(jeng, jplan, directory=str(tmp_path), every=8, on_segment=die)
        assert latest_step(str(tmp_path)) == 16
        plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=32,
                          init_words=init, key=prng.PRNGKey(12), collect="thin:3")
        tr = telemetry.enable()
        got = run_resumable(_engine(randomness=randomness, chunk_steps=8), plan,
                            directory=str(tmp_path), every=8).result
        restores = [e for e in tr.events() if e.name == "run_resumable.restore"]
        assert len(restores) == 1 and restores[0].meta["done"] == 16
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f)).astype(getattr(got, f).numpy().dtype), err_msg=f)

    def test_jax_reads_a_port_directory(self, tmp_path):
        """The port's checkpoints are read and verified by JAX's loader,
        with JAX's dtypes, and JAX's run_resumable finishes them."""
        table, init = _mh_data(2)
        _assert_no_ties(table, init, "cim", prng.PRNGKey(13), 24)
        plan = ts.RunPlan(target=ts.TableTarget(torch.from_numpy(table)), n_steps=24,
                          init_words=init, key=prng.PRNGKey(13))
        engine = _engine(chunk_steps=8)

        def die(done, total, handle):
            if done >= 16:
                raise Die

        with pytest.raises(Die):
            run_resumable(engine, plan, directory=str(tmp_path), every=8, on_segment=die)
        tree, manifest = jax_load_tree(str(tmp_path), 16, verify=True)
        assert {k: str(v.dtype) for k, v in tree.items()} == {
            "acc": "int32", "logp": "float32", "samples": "uint32", "words": "uint32"}
        assert tree["samples"].shape == (16, 2, 8)
        jeng = js.MHEngine(js.EngineConfig(chunk_steps=8))
        jplan = js.RunPlan(target=js.TableTarget(jnp.asarray(table)), n_steps=24,
                           init_words=jnp.asarray(init), key=jax.random.PRNGKey(13))
        got = jax_run_resumable(jeng, jplan, directory=str(tmp_path), every=8).result
        want = engine.submit(plan).result
        np.testing.assert_array_equal(np.asarray(got.samples).astype(np.int64),
                                      want.samples.numpy())
        np.testing.assert_array_equal(np.asarray(got.final_logp), want.final_logp.numpy())
        np.testing.assert_array_equal(np.asarray(got.accept_count), want.accept_count.numpy())

    def test_gibbs_manifest_equals_jax(self, tmp_path):
        """A Gibbs run's checkpoint: the same keys, shapes and dtypes as the
        JAX package's checkpoint of the same run."""
        from repro.workloads.ising import IsingModel as JaxIsing

        model, init = _gibbs_setup()
        run_resumable(_engine(update="gibbs", randomness="fused", chunk_steps=4),
                      ts.RunPlan(target=model, n_steps=12, init_words=init, seed=3,
                                 collect="thin:4"),
                      directory=str(tmp_path / "port"), every=6)
        jax_run_resumable(js.MHEngine(js.EngineConfig(update="gibbs", randomness="fused",
                                                      chunk_steps=4)),
                          js.RunPlan(target=JaxIsing(6, 6), n_steps=12,
                                     init_words=jnp.asarray(init), seed=3, collect="thin:4"),
                          directory=str(tmp_path / "jax"), every=6)
        for step in (6, 12):
            leaves = [
                [(e["key"], e["shape"], e["dtype"]) for e in
                 load_checkpoint_tree(str(tmp_path / d), step)[1]["leaves"]]
                for d in ("port", "jax")
            ]
            assert leaves[0] == leaves[1]
