"""The port's per-device cost counters (``repro_torch.distributed.hlo_cost``
and ``hlo_analysis``) against the JAX package's HLO readers.

The cases of ``tests/test_hlo_cost.py`` that mean something in eager
PyTorch (a product's FLOPs, a gradient at three times its forward), the
per-device count of a product on a 4-rank fake DTensor mesh, the bytes
rules, and ``collective_bytes`` against JAX's on the compiled HLO of the
same explicit all-gather and psum over 4 devices in a ``shard_map``.
JAX runs that in one subprocess (it must set its own device count before
it starts: ``python tests/test_torch_hlo_cost.py OUT``).
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro_torch.distributed import hlo_analysis, hlo_cost

ROOT = Path(__file__).resolve().parents[1]
LOCAL = (4, 8)  # each of the 4 devices' block of a (16, 8) float32 array


def _jax_collectives(out: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed.hlo_analysis import collective_bytes
    from repro.distributed.hlo_cost import analyze_hlo

    mesh = jax.make_mesh((4,), ("i",))

    def body(x):
        return jax.lax.all_gather(x, "i", tiled=True), jax.lax.psum(x, "i")

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("i"), out_specs=(P(), P()),
                              check_vma=False))
    x = jnp.zeros((4 * LOCAL[0], LOCAL[1]), jnp.float32)
    hlo = f.lower(x).compile().as_text()
    with open(os.path.join(out, "jax.json"), "w") as fh:
        json.dump({"collective_bytes": collective_bytes(hlo),
                   "hlo_cost": analyze_hlo(hlo)["collectives"]}, fh)


@contextlib.contextmanager
def _fake_mesh(shape, names):
    import numpy as np
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    n = int(np.prod(shape))
    with dryrun.fake_group(n), hlo_analysis.dtensor_bookkeeping():
        mesh = DeviceMesh("cpu", np.arange(n).reshape(shape).tolist(), mesh_dim_names=names)
        with FakeTensorMode():
            yield mesh, dist
        del mesh


@pytest.mark.parametrize("m,k,n", [(3, 5, 7), (64, 128, 32)])
def test_product_flops(m, k, n):
    a, b = torch.randn(m, k), torch.randn(k, n)
    assert hlo_cost.analyze(torch.mm, a, b)["flops"] == 2 * m * n * k
    assert hlo_cost.analyze(torch.matmul, a, b)["flops"] == 2 * m * n * k
    assert hlo_cost.analyze(torch.addmm, torch.zeros(n), a, b)["flops"] == 2 * m * n * k
    assert hlo_cost.analyze(torch.nn.functional.linear, a, b.t())["flops"] == 2 * m * n * k
    batched = torch.randn(2, m, k)
    assert hlo_cost.analyze(torch.einsum, "bmk,kn->bmn", batched, b)["flops"] == 4 * m * n * k
    assert hlo_cost.analyze(torch.bmm, batched, torch.randn(2, k, n))["flops"] == 4 * m * n * k


def test_elementwise_and_convolution_have_no_flops():
    x = torch.randn(2, 3, 16, 16)
    assert hlo_cost.analyze(lambda: torch.exp(x) * x + 1)["flops"] == 0
    assert hlo_cost.analyze(torch.nn.functional.conv2d, x, torch.randn(4, 3, 3, 3))["flops"] == 0


def test_gradient_is_three_times_the_forward():
    """The forward product and its two gradient products (x^T dy, dy w^T)."""
    x = torch.randn(32, 64, requires_grad=True)
    w = torch.randn(64, 16, requires_grad=True)
    fwd = hlo_cost.analyze(lambda: x @ w)["flops"]

    def step():
        torch.autograd.grad((x @ w).sum(), [x, w])

    assert hlo_cost.analyze(step)["flops"] == 3 * fwd == 3 * 2 * 32 * 64 * 16


def test_sharded_product_counts_the_local_block():
    """On a (2, 2) fake mesh a (64, 32) @ (32, 16) product with its rows
    split over "data" and its columns over "model" counts rank 0's block,
    a quarter of the global product (``FlopCounterMode`` counts the
    global one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with _fake_mesh((2, 2), ("data", "model")) as (mesh, _):
        a = DTensor.from_local(torch.empty(32, 32), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(32, 8), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        with hlo_cost.CostCounter() as cost:
            c = a @ b
        assert tuple(c.shape) == (64, 16)
        assert cost.flops == 2 * 32 * 8 * 32 == 2 * 64 * 16 * 32 / 4
        assert cost.report()["collectives"] == {"total": 0}


def test_region_write_moves_what_it_writes():
    """JAX's dynamic-update-slice rule: an in-place write into a large
    buffer moves the update twice (read, written) and its indices, never
    the buffer; a view moves nothing; a copy moves its operand and result."""
    buf, upd = torch.zeros(64, 1024), torch.ones(64, 4)
    rows, cols = torch.arange(64)[:, None], torch.arange(4)[None, :] + 100
    got = hlo_cost.analyze(lambda: buf.__setitem__((rows, cols), upd))
    assert got["bytes"] == 2 * upd.nbytes + rows.nbytes + cols.nbytes
    assert hlo_cost.analyze(lambda: buf.view(-1).t())["bytes_upper"] == 0
    assert hlo_cost.analyze(lambda: buf.clone())["bytes"] == 2 * buf.nbytes
    assert hlo_cost.analyze(lambda: buf * 2)["bytes"] == 0  # elementwise: upper only
    assert hlo_cost.analyze(lambda: buf * 2)["bytes_upper"] == 2 * buf.nbytes


def test_custom_operator_bytes_are_mandatory():
    """The MH kernel's operator (JAX's custom-call) on fake card tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.mh import mh

    with FakeTensorMode():
        table = torch.empty(4, 1000, device="cuda")
        args = (table, torch.empty(4, 1, dtype=torch.int64, device="cuda"),
                torch.empty(32, 4, 1, dtype=torch.int64, device="cuda"),
                torch.empty(32, 4, 1, device="cuda"))
        got = hlo_cost.analyze(mh.mh_chain, *args, 16)
    moved = 4 * 1000 * 4 + 4 * 8 + 32 * 4 * 8 + 32 * 4 * 4 + 32 * 4 * 8 + 4 * 4
    assert got["bytes"] == got["bytes_upper"] == moved
    assert got["flops"] == 0 and got["unknown_trip_loops"] == 0


def test_collectives_match_jax():
    """An explicit all-gather and psum of a (4, 8) float32 block over 4
    devices: the port's explicit ``c10d`` collectives and DTensor's
    redistributions each give JAX's operand bytes on the ``shard_map``'s
    compiled HLO (``analyze_hlo``, which looks each operand up).  JAX's
    text parser ``collective_bytes`` agrees on the all-reduce; this XLA
    prints operands without their types, so for the all-gather it falls
    back to the result, the gathered array: 4 times the operand."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    out = tempfile.mkdtemp(prefix="torch_hlo_cost_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, __file__, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    with _fake_mesh((4,), ("i",)) as (mesh, dist):
        with hlo_analysis.CollectiveCounter() as explicit:
            x = torch.empty(*LOCAL)
            dist.all_gather_into_tensor(torch.empty(4 * LOCAL[0], LOCAL[1]), x)
            dist.all_reduce(x)
        with hlo_analysis.CollectiveCounter() as dtensor:
            DTensor.from_local(torch.empty(*LOCAL), mesh, [Shard(0)],
                               run_check=False).full_tensor()
            DTensor.from_local(torch.empty(*LOCAL), mesh, [Partial()],
                               run_check=False).full_tensor()
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    with open(os.path.join(out, "jax.json")) as fh:
        jax_side = json.load(fh)
    block = LOCAL[0] * LOCAL[1] * 4
    want = {"all-gather": block, "all-reduce": block, "total": 2 * block, "count": 2}
    for got in (explicit.report(), dtensor.report()):
        assert got == want
        assert {k: v for k, v in got.items() if k != "count"} == jax_side["hlo_cost"]
        text = jax_side["collective_bytes"]
        assert (text["all-reduce"], text["all-gather"], text["count"]) == (
            got["all-reduce"], 4 * got["all-gather"], got["count"])


def test_gathered_weight_is_named():
    """A collective's operand is named after the parameter it is made
    from alone: its shard, a view of it in another shape, a cast of it;
    activations of a weight shard's shape, and a product of a weight with
    them, are not."""
    from torch.distributed.tensor import DTensor, Shard

    with _fake_mesh((4,), ("i",)) as (mesh, dist):
        def param():
            return DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0)], run_check=False)

        weights = {"shard": param(), "view": param(), "cast": param()}
        with hlo_analysis.CollectiveCounter(weights=weights) as c:
            weights["shard"].full_tensor()
            weights["view"].reshape(128).full_tensor()
            weights["cast"].to(torch.bfloat16).full_tensor()
            act = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0)], run_check=False)
            act.full_tensor()
            dist.all_reduce(act.to_local() @ weights["shard"].to_local().t())
    named = [(kind, shape, weight) for kind, _, shape, weight in c.records]
    assert named == [("all-gather", (4, 8), "shard"), ("all-gather", (32,), "view"),
                     ("all-gather", (4, 8), "cast"), ("all-gather", (4, 8), None),
                     ("all-reduce", (4, 4), None)]


def test_collective_over_one_rank_is_not_counted():
    with _fake_mesh((1, 4), ("data", "model")) as (mesh, dist):
        with hlo_analysis.CollectiveCounter() as c:
            dist.all_reduce(torch.empty(8), group=mesh.get_group("data"))
            dist.all_reduce(torch.empty(8), group=mesh.get_group("model"))
    assert c.report() == {"all-reduce": 32, "total": 32, "count": 1}


def test_bookkeeping_is_restored():
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    with hlo_analysis.dtensor_bookkeeping():
        with hlo_analysis.dtensor_bookkeeping():
            assert "_propagate_tensor_meta_non_cached" in vars(prop)
        assert "_propagate_tensor_meta_non_cached" in vars(prop)
    assert "_propagate_tensor_meta_non_cached" not in vars(prop)


if __name__ == "__main__":
    _jax_collectives(sys.argv[1])
