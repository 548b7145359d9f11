"""The int8 error-feedback cross-pod reduction of the port
(``repro_torch.distributed.compression``) on ``gloo`` ranks, against the
JAX package's ``compressed_pmean`` under ``jax.vmap(axis_name="pod")``
on one CPU device (the reference runs in process; its 8-device compile
of the train step aborts inside XLA, ROADMAP queue 3 item 3).

Tolerance 0: the reduced gradients and the error states must equal
JAX's bit for bit, over four iterations that feed each error state into
the next, at 2 pods (plain tensors; the two "data" columns of a (2, 2)
mesh reduce at once, each over its own pair), at 4 pods (a 1-D ("pod",)
mesh) and at 2 pods of 2 "data" ranks (DTensor leaves sharded over
"data" on each pod's sub-mesh).  One 4-rank group runs all three.  The
last case is also the reference's own drift test
(``tests/test_distributed.py:39``): one step within the int8 rounding of
the exact mean, the mean of four steps within 0.6 of that rounding.

Run as a script (``python tests/test_torch_compression.py OUT PORT``)
the file starts the ranks itself; it imports no JAX at module level.
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

from repro_torch.distributed import compression

ROOT = Path(__file__).resolve().parents[1]
ITERS = 4
SHAPES = {"w": (64,), "b": (3, 5), "big": (34, 17)}
# name -> (mesh shape, mesh dimension names, leaves are DTensors over "data");
# one 4-rank group holds every run: 2 pods twice over (the two "data"
# columns of a (2, 2) mesh, each its own pair), 4 pods, and 2 pods of 2
# "data" ranks
WORLD = 4
RUNS = {
    "pods2": ((2, 2), ("pod", "data"), False),
    "pods4": ((4,), ("pod",), False),
    "pods2_data2": ((2, 2), ("pod", "data"), True),
}


def _grads(n_pods):
    """ITERS steps of per-pod gradients {name: (ITERS, n_pods, *shape)}, in
    spreads of 1e-3 to 10, and a nonzero first error state."""
    rs = np.random.default_rng(n_pods)
    g = {n: (rs.normal(size=(ITERS, n_pods, *s)) * 10.0 ** rs.integers(-3, 2)).astype(np.float32)
         for n, s in SHAPES.items()}
    e = {n: (rs.normal(size=(n_pods, *s)) * 1e-3).astype(np.float32) for n, s in SHAPES.items()}
    return g, e


def _drift_grads():
    """tests/test_distributed.py:48: two pods' gradients of 64 elements."""
    return np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)


# --- the ranks (run in the subprocess) --------------------------------------


def _rank(rank, port, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        for name, (shape, names, sharded) in RUNS.items():
            mesh = DeviceMesh("cpu", np.arange(WORLD).reshape(shape).tolist(),
                              mesh_dim_names=names)
            _run(rank, out, name, mesh, sharded, DTensor, Replicate, Shard)
    finally:
        dist.destroy_process_group()


def _run(rank, out, name, mesh, sharded, DTensor, Replicate, Shard):
    pod = mesh.get_local_rank(0)
    n_pods = mesh.size(0)
    inner = mesh["data"] if sharded else None

    def leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not sharded:
            return t
        return DTensor.from_local(t, inner, [Replicate()],
                                  run_check=False).redistribute(inner, [Shard(0)])

    def whole(t):
        return (t.full_tensor() if sharded else t).numpy()

    g, e = _grads(n_pods)
    drift = _drift_grads()
    err = {n: leaf(v[pod]) for n, v in e.items()}
    derr = leaf(np.zeros(64, np.float32))
    saved = {"pod": np.array(pod)}
    compression.PAYLOAD.clear()
    for it in range(ITERS):
        grads = {n: leaf(v[it, pod]) for n, v in g.items()}
        red, err = compression.compressed_psum_pod(grads, err, mesh)
        for n in SHAPES:
            saved[f"red_{n}_{it}"], saved[f"err_{n}_{it}"] = whole(red[n]), whole(err[n])
        if sharded:
            dred, dnew = compression.compressed_psum_pod({"w": leaf(drift[pod])},
                                                         {"w": derr}, mesh)
            saved[f"drift_{it}"], derr = whole(dred["w"]), dnew["w"]
    local = [t.to_local() if sharded else t for t in (*grads.values(), derr)]
    saved["local_words"] = np.array(sum(t.numel() for t in local[:len(SHAPES) + sharded]))
    saved["payload"] = np.array([compression.PAYLOAD[k] for k in ("int32", "float32")])
    saved["payload_dtypes"] = np.array(sorted(compression.PAYLOAD))
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **saved)


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
def runs():
    """{run name: [each rank's saved arrays]}."""
    out = tempfile.mkdtemp(prefix="torch_compression_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    port = _free_port()
    proc = subprocess.run([sys.executable, __file__, out, str(port)], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {name: [dict(np.load(os.path.join(out, f"{name}_rank{r}.npz"))) for r in range(WORLD)]
            for name in RUNS}


def _jax_steps(g, e):
    """JAX's compressed_pmean under vmap over the pod axis, ITERS steps with
    the error state fed forward: [(reduced, err) per step], each leaf with
    a leading pod axis."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.compression import compressed_pmean

    fn = jax.jit(jax.vmap(lambda g_, e_: compressed_pmean(g_, e_, "pod"), axis_name="pod"))
    err = {n: jnp.asarray(v) for n, v in e.items()}
    out = []
    for it in range(ITERS):
        red, err = fn({n: jnp.asarray(v[it]) for n, v in g.items()}, err)
        out.append(({n: np.asarray(v) for n, v in red.items()},
                    {n: np.asarray(v) for n, v in err.items()}))
    return out


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("it", range(ITERS))
def test_compressed_pmean_equals_jax(runs, name, it):
    """Every rank's reduced gradients and error state at step ``it``
    against JAX's for its pod, bit for bit."""
    n_pods = RUNS[name][0][0]
    g, e = _grads(n_pods)
    red, err = _jax_steps(g, e)[it]
    for got in runs[name]:
        pod = int(got["pod"])
        for n in SHAPES:
            np.testing.assert_array_equal(got[f"red_{n}_{it}"], red[n][pod], err_msg=f"{n} red")
            np.testing.assert_array_equal(got[f"err_{n}_{it}"], err[n][pod], err_msg=f"{n} err")


@pytest.mark.parametrize("name", list(RUNS))
def test_payload_is_int32_words_and_float32_scales(runs, name):
    """The pod all-reduce sends each rank's quantised words as int32 and
    one float32 scale a leaf, nothing else."""
    n_leaves = len(SHAPES) + (name == "pods2_data2")  # the drift test's leaf
    for got in runs[name]:
        assert got["payload_dtypes"].tolist() == ["float32", "int32"]
        assert got["payload"].tolist() == [4 * int(got["local_words"]) * ITERS,
                                           4 * n_leaves * ITERS]


def test_drift_of_the_reference_test(runs):
    """tests/test_distributed.py:39-80 on the port: one step within the
    int8 rounding of the exact mean, the mean of four within 0.6 of it."""
    g_pods = _drift_grads()
    true_mean = g_pods.mean(axis=0)
    scale = np.abs(g_pods).max() / 127.0
    for got in runs["pods2_data2"]:
        acc = np.zeros(64)
        for it in range(ITERS):
            red = got[f"drift_{it}"]
            assert np.abs(red - true_mean).max() <= scale * 1.01, it
            acc += red
        assert np.abs(acc / ITERS - true_mean).max() <= scale * 0.6


def test_plain_version_is_one_pod():
    """The plain version reduces over one pod and sends nothing: the
    gradient comes back rounded to the int8 grid of its absmax, and the
    error state holds the rounding."""
    rs = np.random.default_rng(3)
    g = {"w": torch.from_numpy(rs.normal(size=(40,)).astype(np.float32))}
    e = compression.init_error_state(g)
    assert e["w"].dtype == torch.float32 and torch.equal(e["w"], torch.zeros(40))
    compression.PAYLOAD.clear()
    red, err = compression.compressed_mean_one_pod(g, e)
    assert not compression.PAYLOAD
    half_step = float(g["w"].abs().max()) / 127.0 / 2 * (1 + 1e-6)
    assert float((red["w"] - g["w"]).abs().max()) <= half_step
    assert float(err["w"].abs().max()) <= half_step
    assert float(red["w"].abs().max()) == float(g["w"].abs().max())


if __name__ == "__main__":
    _launch(sys.argv[1], int(sys.argv[2]))
