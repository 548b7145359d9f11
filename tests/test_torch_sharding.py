"""Chain-axis sharding of the port: ``RunPlan(mesh=...)`` over a 1-D
``DeviceMesh`` on a 4-rank ``gloo`` group (the CPU stand-in for four
cards), against the unsharded port run and the JAX package's run.

The ranks run in a subprocess with a time limit, so a hung rendezvous
fails the tests instead of stalling the suite.  Each rank runs its slice
of the chains and all-gathers the result; every rank's result must equal
the unsharded run word for word (chains never talk to each other).  The
MH cases assert that their draws hold no tie event, the parity
contract's one exception against JAX; Gibbs ``final_logp`` is held
within 4 ULP of JAX's, the gap between the two log-sigmoids.

Run as a script (``python tests/test_torch_sharding.py OUT PORT``) the
file starts the four ranks itself; it imports no JAX at module level.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch import samplers as ts
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.workloads import ising

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SEED, N, CHUNK = 11, 12, 5
B, V, CC = 2, 45, 3  # MH: rows, vocab, columns per chain
LAT = 6              # Gibbs: 6 x 6 Ising lattices, B of them per chain
FIELDS = ("samples", "accept_count", "acceptance_rate", "final_words", "final_logp")

# name -> (update, randomness, execution, num_chains, collect)
CASES = {
    "mh_fused": ("mh", "fused", "pallas", 4, "all"),
    "mh_cim_scan": ("mh", "cim", "scan", 8, "thin:3"),
    "mh_host_last": ("mh", "host", "pallas", 4, "last"),
    "mh_replicated": ("mh", "fused", "pallas", 6, "all"),  # 4 does not divide 6
    "gibbs_fused": ("gibbs", "fused", "pallas", 4, "all"),
    "gibbs_host_scan": ("gibbs", "host", "scan", 8, "thin:4"),
}


def _mh_data(num_chains):
    rs = np.random.default_rng(SEED)
    table = (rs.normal(size=(B, V)) * 2).astype(np.float32)
    init = rs.integers(0, V, size=(num_chains, B, CC)).astype(np.uint32)
    return table, init


def _gibbs_init(num_chains):
    rs = np.random.default_rng(SEED + 1)
    return rs.integers(0, 2, size=(num_chains, B, LAT, LAT)).astype(np.uint32)


def _port_case(name):
    """(engine, plan) of a case on the CPU, without a mesh."""
    update, randomness, execution, num_chains, collect = CASES[name]
    cfg = ts.EngineConfig(
        update=update, randomness=randomness, execution=execution, p_bfr=0.4,
        chunk_steps=CHUNK, num_chains=num_chains, collect=collect,
    )
    if update == "mh":
        table, init = _mh_data(num_chains)
        target = ts.TableTarget(torch.from_numpy(table))
    else:
        target = ising.IsingModel(LAT, LAT, beta=0.4407, field=0.05)
        init = _gibbs_init(num_chains)
    plan = ts.RunPlan(target=target, n_steps=N, init_words=init, key=prng.PRNGKey(SEED))
    return ts.MHEngine(cfg, device="cpu"), plan


def _fields(result):
    return {f: getattr(result, f).numpy() for f in FIELDS}


# --- the ranks (run in the subprocess) --------------------------------------


def _rank(rank, port, out):
    import torch.distributed as dist

    from repro_torch.checkpoint import run_resumable

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
    )
    try:
        mesh = tmesh.make_chains_mesh(device_type="cpu")
        assert tmesh.mesh_chip_count(mesh) == WORLD
        for name in CASES:
            engine, plan = _port_case(name)
            res = engine.submit(plan.replace(mesh=mesh)).result
            np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **_fields(res))
        # a sharded resumable run, killed after its first segment and
        # finished by a second call on the same directory
        engine, plan = _port_case("mh_fused")
        directory = os.path.join(out, f"ckpt_rank{rank}")

        class Preempted(RuntimeError):
            pass

        def die(done, total, handle):
            if done == CHUNK:
                raise Preempted

        try:
            run_resumable(engine, plan.replace(mesh=mesh), directory=directory,
                          every=CHUNK, on_segment=die)
        except Preempted:
            pass
        res = run_resumable(engine, plan.replace(mesh=mesh), directory=directory,
                            every=CHUNK).result
        np.savez(os.path.join(out, f"resume_rank{rank}.npz"), **_fields(res))
    finally:
        dist.destroy_process_group()


def _launch(out, port):
    import torch.multiprocessing as mp

    torch.set_num_threads(1)
    mp.spawn(_rank, args=(port, out), nprocs=WORLD)


# --- the tests ---------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded_runs():
    """Every case run on the 4-rank mesh: {name: [rank results]}."""
    out = tempfile.mkdtemp(prefix="torch_sharding_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, __file__, out, str(_free_port())],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {
        name: [dict(np.load(os.path.join(out, f"{name}_rank{r}.npz"))) for r in range(WORLD)]
        for name in (*CASES, "resume")
    }


def _unsharded(name):
    engine, plan = _port_case(name)
    return _fields(engine.submit(plan).result)


def _assert_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_unsharded(sharded_runs, name):
    want = _unsharded(name)
    for rank, got in enumerate(sharded_runs[name]):
        assert got["samples"].shape == want["samples"].shape, rank
        _assert_equal(got, want)


def test_sharded_resume_equals_unsharded(sharded_runs):
    want = _unsharded("mh_fused")
    for got in sharded_runs["resume"]:
        _assert_equal(got, want)


def _no_mh_ties(name):
    from repro_torch.kernels.mh import ref

    engine, plan = _port_case(name)
    table, init = _mh_data(engine.config.num_chains)
    backend = engine.config.backend()
    keys = ts.chain_keys(prng.PRNGKey(SEED), engine.config.num_chains)
    for c, key in enumerate(keys):
        flips, u = backend.chunk(key, 0, N, (B, CC), plan.target.nbits)
        ties = ref.tie_events(torch.from_numpy(table), torch.from_numpy(init[c].astype(np.int64)),
                              flips, u, plan.target.nbits)
        assert ties.shape[0] == 0, f"tie events {ties.tolist()} in chain {c}"


def _no_gibbs_ties(name):
    from repro_torch.kernels.gibbs import ref

    engine, plan = _port_case(name)
    backend = engine.config.backend()
    init = torch.from_numpy(_gibbs_init(engine.config.num_chains).astype(np.int64))
    for c, key in enumerate(ts.chain_keys(prng.PRNGKey(SEED), engine.config.num_chains)):
        _, u = backend.chunk(key, 0, N, (B, LAT, LAT), 1, need_flips=False)
        ties = ref.chain_ties(init[c], u, plan.target.logit_spec, 0)
        assert ties.shape[0] == 0, f"tie events {ties.tolist()} in chain {c}"


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_jax(sharded_runs, name):
    """Rank 0's sharded result against the JAX package's run of the same
    plan (the JAX engine on its scan executor, in one chunk)."""
    import jax.numpy as jnp

    from repro import samplers as js
    from repro.workloads import ising as jising

    update, randomness, _, num_chains, collect = CASES[name]
    # one chunk: chunking never changes the stream, and JAX compiles one scan
    cfg = js.EngineConfig(update=update, randomness=randomness, execution="scan", p_bfr=0.4,
                          chunk_steps=N, num_chains=num_chains, collect=collect)
    if update == "mh":
        _no_mh_ties(name)
        table, init = _mh_data(num_chains)
        target = js.TableTarget(jnp.asarray(table))
    else:
        _no_gibbs_ties(name)
        target = jising.IsingModel(LAT, LAT, beta=0.4407, field=0.05)
        init = _gibbs_init(num_chains)
    key = np.asarray([0, SEED], np.uint32)
    ref = js.MHEngine(cfg).submit(js.RunPlan(target=target, n_steps=N,
                                             init_words=jnp.asarray(init), key=key)).result
    got = sharded_runs[name][0]
    for f in ("samples", "accept_count", "final_words"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)).astype(got[f].dtype),
                                      err_msg=f)
    np.testing.assert_array_equal(got["acceptance_rate"], np.asarray(ref.acceptance_rate))
    ulps = 0 if update == "mh" else 4
    want = np.asarray(ref.final_logp)
    np.testing.assert_array_less(np.abs(got["final_logp"] - want),
                                 ulps * np.spacing(np.abs(want)) + np.finfo(np.float32).tiny)


class _Mesh:
    """A stand-in with a DeviceMesh's shape interface, for the rule alone."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self._sizes = tuple(dims.values())
        self.ndim = len(dims)

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]


@pytest.mark.parametrize("dims,chains,want", [
    (dict(data=4), 8, ("data",)),
    (dict(data=4), 6, ()),               # not divisible: replicated
    (dict(data=1), 4, ("data",)),        # the one-card mesh
    (dict(pod=2, data=2), 8, (("pod", "data"),)),
    (dict(pod=2, data=3), 4, ("pod",)),  # data does not divide what pod leaves
    (dict(model=4), 8, ()),              # no axis of the rule
])
def test_chains_rule(dims, chains, want):
    assert sharding.spec_for(("chains",), shape=(chains,), mesh=_Mesh(**dims)) == want
    assert sharding.spec_for(("chains",), shape=(chains,), mesh=None) is None


def test_make_chains_mesh_below_two_devices():
    assert tmesh.make_chains_mesh() is None  # no process group: one device
    assert tmesh.make_chains_mesh(1) is None
    assert tmesh.make_chains_mesh(devices=[0], device_type="cpu") is None
    assert tmesh.make_chains_mesh(4, devices=[], device_type="cpu") is None


def test_solo_run_ignores_mesh():
    """A solo run (num_chains == 1) never reads its mesh, as in JAX."""
    engine, plan = _port_case("mh_fused")
    solo = ts.MHEngine(ts.EngineConfig(p_bfr=0.4, chunk_steps=CHUNK, randomness="fused"),
                       device="cpu")
    plan = plan.replace(init_words=plan.init_words[0])
    a = solo.submit(plan).result
    b = solo.submit(plan.replace(mesh=_Mesh(data=4))).result
    _assert_equal(_fields(b), _fields(a))


if __name__ == "__main__":
    _launch(sys.argv[1], int(sys.argv[2]))
