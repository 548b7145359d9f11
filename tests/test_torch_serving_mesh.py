"""The port's serving mesh: ``Scheduler(mesh=...)`` shards each scan
class call's slot axis over a 1-D ``DeviceMesh`` (the JAX package's
``serving/dispatch.py:_slot_axis_wrap``), on a 4-rank ``gloo`` group (the
CPU stand-in for four cards), against the unsharded port and the JAX
package's solo runs (``tests/test_multidevice.py:TestShardedServing``,
``tests/test_serving.py:TestMeshServingSmoke``).

The ranks run in a subprocess with a time limit, so a hung rendezvous
fails the tests instead of stalling the suite.  Each rank serves the same
requests; with 4 slots each runs the occupied slots of its block and an
all-gather joins them, with 3 slots (which 4 does not divide) every rank
runs every slot.  Arrivals are staggered, so the ranks must admit on one
clock.  Every rank's requests must equal the unsharded port's word for
word (slots never talk to each other) and the JAX package's solo runs,
whose draws are asserted free of tie events.

Run as a script (``python tests/test_torch_serving_mesh.py OUT PORT``) the
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

from repro_torch import prng, workloads
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import ref as mref
from repro_torch.launch import mesh as tmesh
from repro_torch.samplers import chain_key, parse_collect
from repro_torch.serving import PackedExecutor, Scheduler, ServeRequest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CHUNK = 8
FIELDS = ("samples", "final_words", "accept_count", "final_logp")
# (workload, n_steps, seed, collect, t_arrive): the JAX package's sharded
# burst, with arrivals staggered so that slots join mid-flight
REQUESTS = (
    ("gmm", 16, 1, "all", 0.0),
    ("ising", 12, 2, "all", 0.0),
    ("gmm", 24, 3, "last", 0.002),
    ("ising", 8, 4, "last", 0.004),
    ("gmm", 16, 5, "thin:4", 0.006),
)
SLOTS = {"sharded": 4, "replicated": 3}


def _requests():
    return [ServeRequest(rid=i, workload=w, n_steps=n, seed=s, collect=c, t_arrive=t)
            for i, (w, n, s, c, t) in enumerate(REQUESTS)]


def _serve(n_slots, mesh=None, counts=None):
    """{rid: fields} of the burst served on the CPU; with ``counts`` (a
    list), appends the slot steps this process ran (over all segments)."""
    from repro_torch.samplers import MHEngine

    real, runs = MHEngine.submit, []

    def submit(self, plan, **kw):
        runs.append(plan.n_steps)
        return real(self, plan, **kw)

    MHEngine.submit = submit
    try:
        done = Scheduler(n_slots=n_slots, smoke=True, chunk_steps=CHUNK, mesh=mesh,
                         device="cpu").serve(_requests())
    finally:
        MHEngine.submit = real
    assert len(done) == len(REQUESTS)
    if counts is not None:
        counts.append(sum(runs))
    return {r.rid: {f: np.asarray(getattr(r, f)) for f in FIELDS} for r in done}


# --- the ranks (run in the subprocess) --------------------------------------


def _rank(rank, port, out):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
    )
    try:
        mesh = tmesh.make_chains_mesh(device_type="cpu")
        assert tmesh.mesh_chip_count(mesh) == WORLD
        for case, n_slots in SLOTS.items():
            counts = []
            for rid, fields in _serve(n_slots, mesh, counts).items():
                np.savez(os.path.join(out, f"{case}_rank{rank}_req{rid}.npz"), **fields)
            np.save(os.path.join(out, f"{case}_rank{rank}_steps.npy"), counts[0])
        try:
            PackedExecutor.for_workload("gmm", n_slots=4, execution="pallas", smoke=True,
                                        mesh=mesh, device="cpu")
            refused = ""
        except ValueError as e:
            refused = str(e)
        with open(os.path.join(out, f"pallas_rank{rank}.txt"), "w") as f:
            f.write(refused)
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
def mesh_runs():
    """The ranks' output directory."""
    out = tempfile.mkdtemp(prefix="torch_serving_mesh_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, __file__, out, str(_free_port())],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def unsharded():
    """{n_slots: (results, slot steps run)} of the unsharded burst."""
    out = {}
    for n in set(SLOTS.values()):
        counts = []
        out[n] = (_serve(n, counts=counts), counts[0])
    return out


def _rank_results(out, case, rank):
    return {rid: dict(np.load(os.path.join(out, f"{case}_rank{rank}_req{rid}.npz")))
            for rid in range(len(REQUESTS))}


def _assert_equal(got, want):
    for rid in want:
        for f in FIELDS:
            np.testing.assert_array_equal(got[rid][f], want[rid][f], err_msg=f"req {rid} {f}")
            assert got[rid][f].dtype == want[rid][f].dtype


@pytest.mark.parametrize("case", list(SLOTS))
@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_burst_equals_unsharded(mesh_runs, unsharded, case, rank):
    _assert_equal(_rank_results(mesh_runs, case, rank), unsharded[SLOTS[case]][0])


@pytest.mark.parametrize("case", list(SLOTS))
def test_mesh_splits_the_slot_steps(mesh_runs, unsharded, case):
    """Sharded, the ranks run the burst's steps between them, each step
    once; replicated, every rank runs all of them.  (Counted in steps, not
    segments: where a segment ends depends on when a request was
    admitted, a request's step budget does not.)"""
    runs = [int(np.load(os.path.join(mesh_runs, f"{case}_rank{r}_steps.npy")))
            for r in range(WORLD)]
    want = sum(n for _, n, *_ in REQUESTS)
    assert unsharded[SLOTS[case]][1] == want
    if case == "sharded":
        assert sum(runs) == want and max(runs) < want
    else:
        assert runs == [want] * WORLD


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_refuses_pallas(mesh_runs, rank):
    with open(os.path.join(mesh_runs, f"pallas_rank{rank}.txt")) as f:
        assert "mesh" in f.read()


def _assert_no_ties(workload, seed, n_steps):
    k_init, k_run = prng.split(prng.PRNGKey(seed))
    wl = workloads.build(workload, k_init, smoke=True, device="cpu")
    init = wl.init_words
    if workload == "gmm":
        flips, u = wl.engine.randomness.chunk(chain_key(k_run, 0), 0, n_steps,
                                              tuple(init.shape), wl.target.nbits)
        ties = mref.tie_events(wl.target.table, init, flips, u, wl.target.nbits, logp_ulps=4)
    else:
        _, u = wl.engine.randomness.chunk(chain_key(k_run, 0), 0, n_steps, tuple(init.shape),
                                          1, need_flips=False)
        ties = gref.chain_ties(init, u, wl.target.logit_spec)
    assert ties.shape[0] == 0, f"tie events in {workload} seed {seed}: {ties[:4].tolist()}"


@pytest.mark.parametrize("rid", range(len(REQUESTS)))
def test_mesh_burst_equals_jax_solo(mesh_runs, rid):
    """Rank 0's sharded request against the JAX package's solo run of the
    same seed (``PRNGKey(seed)`` split into init and run keys, ``cim``)."""
    import jax

    from repro import workloads as jw

    workload, n_steps, seed, collect, _ = REQUESTS[rid]
    _assert_no_ties(workload, seed, n_steps)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    wl = jw.build(workload, k_init, smoke=True)
    ref = wl.engine.run(k_run, wl.target, n_steps, wl.init_words, collect="all")
    mode, k = parse_collect(collect)
    samples = np.asarray(ref.samples)
    kept = {"all": samples, "thin": samples[::max(k, 1)], "last": samples[:0]}[mode]
    got = _rank_results(mesh_runs, "sharded", 0)[rid]
    np.testing.assert_array_equal(got["samples"], kept)
    np.testing.assert_array_equal(got["final_words"], np.asarray(ref.final_words))
    np.testing.assert_array_equal(got["accept_count"], np.asarray(ref.accept_count))


def test_one_rank_mesh_equals_unsharded(unsharded):
    """A one-rank ``gloo`` mesh in this process: the slot axis resolves to
    the mesh's one rank, and the burst equals the unsharded one (the JAX
    package's one-device mesh test)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("data",))
        _assert_equal(_serve(4, mesh), unsharded[4][0])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _launch(sys.argv[1], int(sys.argv[2]))
