"""The port's serving tier against the JAX package's
(``tests/test_serving.py``).

Packing requests into an executor's slot axis must never change any
request's numbers: a request admitted mid-flight, sharing the batch with
strangers, retiring early or reusing a slot reproduces its solo run.
Each scenario of the JAX package's tests runs here on the port (CPU:
``pallas`` runs the kernels' plain versions) at smoke sizes, and every
served request is held against the JAX package's solo ``engine.run`` of
the same seed — ``PRNGKey(seed)`` split into the workload's init key and
the run key, as ``launch.sample`` derives them — at tolerance 0: kept
samples, final words and accept counts.  One JAX run per (workload,
seed, steps, randomness) serves every executor and collection mode (the
JAX package holds its executors equal, and ``thin``/``last`` are views
of the ``all`` stream); step budgets of 16, 32 and 48 keep the JAX
side's compiled chunk lengths to two.  Every reference is replayed first for tie
events (the ``gmm`` table is the port's own, within an ULP of JAX's, so
its window is widened by 4 ULP of each log-prob), and the seeds are
asserted free of them.
"""

import jax
import numpy as np
import pytest
import torch

from repro import workloads as jw
from repro_torch import prng, workloads
from repro_torch import serving as serving_pkg
from repro_torch.kernels.gibbs import ref as gref
from repro_torch.kernels.mh import ref as mref
from repro_torch.samplers import chain_key, parse_collect
from repro_torch.serving import (
    FIFOQueue,
    PackedExecutor,
    Scheduler,
    ServeRequest,
    dispatch,
    latency_summary,
)

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)
pytestmark = partitionable
GMM_DEFAULT_STEPS = 96  # the smoke gmm workload's step budget


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_no_ties(workload, seed, n_steps, randomness):
    """Replay the port's solo run of a request for tie events."""
    k_init, k_run = prng.split(prng.PRNGKey(seed))
    wl = workloads.build(workload, k_init, randomness=randomness, smoke=True, device="cpu")
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


_JAX_SOLO = {}


def jax_solo(workload, seed, n_steps, randomness):
    """The JAX package's solo run of a request, collect "all"."""
    key = (workload, seed, n_steps, randomness)
    if key not in _JAX_SOLO:
        _assert_no_ties(*key)
        k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
        wl = jw.build(workload, k_init, randomness=randomness, backend="pallas", smoke=True)
        res = wl.engine.run(k_run, wl.target, n_steps, wl.init_words, collect="all")
        _JAX_SOLO[key] = {f: np.asarray(getattr(res, f))
                          for f in ("samples", "final_words", "accept_count")}
    return _JAX_SOLO[key]


def assert_matches_solo(req, randomness="cim", n_steps=None):
    n = n_steps or req.n_steps
    ref = jax_solo(req.workload, req.seed, n, randomness)
    mode, k = parse_collect(req.collect)
    kept = {"all": ref["samples"], "thin": ref["samples"][::max(k, 1)],
            "last": ref["samples"][:0]}[mode]
    np.testing.assert_array_equal(req.samples, kept)
    np.testing.assert_array_equal(req.final_words, ref["final_words"])
    np.testing.assert_array_equal(req.accept_count, ref["accept_count"])
    total = n * int(np.prod(ref["final_words"].shape))
    assert req.acceptance_rate == float(ref["accept_count"].sum()) / total
    assert req.samples.dtype == np.uint32 and req.final_words.dtype == np.uint32


def make_executor(workload="gmm", n_slots=2, chunk_steps=8, *, randomness="cim",
                  execution="scan"):
    return PackedExecutor.for_workload(workload, n_slots=n_slots, randomness=randomness,
                                       execution=execution, smoke=True,
                                       chunk_steps=chunk_steps, device="cpu")


def run_to_completion(ex):
    done = []
    while ex.active_count:
        done.extend(ex.advance_chunk())
    ex.drain()
    return done


def req(rid, workload, n_steps, seed, collect="all", **kw):
    return ServeRequest(rid=rid, workload=workload, n_steps=n_steps, seed=seed,
                        collect=collect, **kw)


# --- mid-flight join and leave, slot reuse, collection ----------------------


def test_join_mid_flight_is_bit_exact():
    ex = make_executor()
    a = req(0, "gmm", 48, 1)
    ex.admit(a)
    for _ in range(2):
        ex.advance_chunk()
    b = req(1, "gmm", 16, 2)
    ex.admit(b)
    assert {r.rid for r in run_to_completion(ex)} == {0, 1}
    assert_matches_solo(a)
    assert_matches_solo(b)


def test_leave_does_not_perturb_survivor():
    ex = make_executor()
    a, b = req(0, "gmm", 48, 1), req(1, "gmm", 16, 2, "last")
    ex.admit(a)
    ex.admit(b)
    run_to_completion(ex)
    assert_matches_solo(a)
    assert_matches_solo(b)


def test_gibbs_mid_flight_join():
    """A mid-flight join resumes the right checkerboard colour."""
    ex = make_executor("ising", chunk_steps=4)
    a = req(0, "ising", 32, 5)
    ex.admit(a)
    ex.advance_chunk()  # a at step 4 when b joins
    b = req(1, "ising", 16, 6)
    ex.admit(b)
    assert {r.rid for r in run_to_completion(ex)} == {0, 1}
    assert_matches_solo(a)
    assert_matches_solo(b)
    assert a.rate_label == "flip_rate"


def test_retire_and_replace_is_bit_exact():
    """Three requests through one slot: streams belong to the request."""
    ex = make_executor(n_slots=1)
    reqs = [req(1, "gmm", 48, 1), req(2, "gmm", 16, 2), req(3, "gmm", 32, 3)]
    for r in reqs:
        assert ex.admit(r) == 0
        run_to_completion(ex)
    for r in reqs:
        assert_matches_solo(r)


def test_per_request_collect_modes():
    ex = make_executor(n_slots=3)
    ra, rt, rl = req(0, "gmm", 48, 1), req(1, "gmm", 48, 1, "thin:8"), req(2, "gmm", 48, 1, "last")
    for r in (ra, rt, rl):
        ex.admit(r)
    run_to_completion(ex)
    for r in (ra, rt, rl):
        assert_matches_solo(r)
    np.testing.assert_array_equal(rt.samples, ra.samples[::8])
    assert rl.samples.shape[0] == 0
    np.testing.assert_array_equal(rl.final_words, ra.final_words)


# --- shape classes (scan) -----------------------------------------------------


def test_mixed_burst_shares_one_class():
    sched = Scheduler(n_slots=4, smoke=True, chunk_steps=8, device="cpu")
    reqs = [req(0, "gmm", 16, 2), req(1, "ising", 16, 6), req(2, "gmm", 32, 3, "last"),
            req(3, "ising", 32, 5, "last")]
    done = sched.serve(reqs)
    assert len(done) == 4 and sched.shape_classes == 1 and len(sched.executors) == 1
    for r in done:
        assert_matches_solo(r)
    by_rid = {r.rid: r for r in done}
    assert by_rid[1].rate_label == "flip_rate"
    assert by_rid[0].rate_label == "acceptance_rate"


def test_mixed_mid_flight_join_is_bit_exact():
    ex = make_executor()
    ex.add_workload("ising", randomness="cim", execution="scan", smoke=True)
    a = req(0, "gmm", 48, 1)
    ex.admit(a)
    for _ in range(2):
        ex.advance_chunk()
    b = req(1, "ising", 32, 5)
    ex.admit(b)
    assert {r.rid for r in run_to_completion(ex)} == {0, 1}
    assert_matches_solo(a)
    assert_matches_solo(b)


def test_add_member_while_live_grows_pad():
    ex = make_executor()
    a = req(0, "gmm", 32, 3)
    ex.admit(a)
    ex.advance_chunk()
    pad_before = ex.n_pad
    ex.add_workload("ising", randomness="cim", execution="scan", smoke=True)
    assert ex.n_pad > pad_before
    run_to_completion(ex)
    assert_matches_solo(a)


# --- packed pallas --------------------------------------------------------------


def test_pallas_slots_match_solo():
    ex = make_executor(execution="pallas")
    a, b = req(0, "gmm", 16, 2), req(1, "gmm", 32, 3, "last")
    ex.admit(a)
    ex.admit(b)
    run_to_completion(ex)
    assert_matches_solo(a)
    assert_matches_solo(b)


@pytest.mark.parametrize("randomness", ["host", "fused"])
def test_packed_pallas_gmm_mid_flight_join(randomness):
    ex = make_executor(randomness=randomness, execution="pallas")
    a = req(0, "gmm", 32, 3)
    ex.admit(a)
    ex.advance_chunk()
    b = req(1, "gmm", 16, 2, "thin:3")
    ex.admit(b)
    assert {r.rid for r in run_to_completion(ex)} == {0, 1}
    assert_matches_solo(a, randomness)
    assert_matches_solo(b, randomness)


@pytest.mark.parametrize("randomness", ["cim", "fused"])
def test_packed_pallas_ising_mid_flight_join(randomness):
    """Gibbs slots fold into the lattice axis; a mid-flight join resumes
    on its own colour (the per-lattice parity / step base operands)."""
    ex = make_executor("ising", chunk_steps=4, randomness=randomness, execution="pallas")
    a = req(0, "ising", 32, 5)
    ex.admit(a)
    ex.advance_chunk()
    b = req(1, "ising", 16, 6)
    ex.admit(b)
    assert {r.rid for r in run_to_completion(ex)} == {0, 1}
    assert_matches_solo(a, randomness)
    assert_matches_solo(b, randomness)


def test_mixed_pallas_burst_one_class_per_workload():
    sched = Scheduler(n_slots=2, randomness="fused", execution="pallas", smoke=True,
                      chunk_steps=8, device="cpu")
    done = sched.serve([req(0, "gmm", 16, 2), req(1, "ising", 16, 6),
                        req(2, "gmm", 32, 3, "last")])
    assert len(done) == 3 and sched.shape_classes == 2
    for r in done:
        assert_matches_solo(r, "fused")


def test_packed_pallas_matches_packed_scan():
    def burst():
        return [req(0, "gmm", 16, 2), req(1, "ising", 16, 6)]

    runs = {}
    for execution in ("pallas", "scan"):
        runs[execution] = {r.rid: r for r in Scheduler(
            n_slots=2, randomness="fused", execution=execution, smoke=True, chunk_steps=8,
            device="cpu").serve(burst())}
    for rid in (0, 1):
        np.testing.assert_array_equal(runs["pallas"][rid].samples, runs["scan"][rid].samples)
        np.testing.assert_array_equal(runs["pallas"][rid].final_words,
                                      runs["scan"][rid].final_words)
        assert_matches_solo(runs["pallas"][rid], "fused")


def test_advance_signatures_are_counted():
    """``advance_compiles`` counts distinct (seg, collect) signatures, the
    programs the JAX package compiles: the kernel advance keeps one
    program for each (on the CPU the record of its signature)."""
    ex = make_executor(execution="pallas")
    ex.admit(req(0, "gmm", 20, 2))
    run_to_completion(ex)
    assert ex.advance_compiles == 2  # (8, "all") and the final (4, "all")
    assert set(ex._advance.programs) == {(8, "all"), (4, "all")}
    assert dispatch.jit_cache_size(ex._advance) == 2
    assert dispatch.jit_cache_size(len) == 0


def test_scan_class_runs_every_slot_through_its_programs():
    """A two-member scan class on 4 slots, 2 of them free: each chunk is
    one call of the class's program of its ``(seg, collect)``, handed the
    slots' layout, in which each occupied slot runs its own member's
    segment at a tensor step base and a free slot runs nothing.  Every
    request equals its solo run and the JAX scheduler's (whose free slots
    run under ``vmap``), and the signatures are the JAX advance's
    ``_cache_size()``."""
    from repro import serving as jsv
    from repro.serving import dispatch as jdispatch
    from repro_torch.samplers import MHEngine

    def burst(pkg):
        return [pkg.ServeRequest(rid=0, workload="gmm", n_steps=16, seed=2, collect="all"),
                pkg.ServeRequest(rid=1, workload="ising", n_steps=16, seed=6, collect="all")]

    jsched = jsv.Scheduler(n_slots=4, randomness="fused", smoke=True, chunk_steps=6)
    want = {r.rid: r for r in jsched.serve(burst(jsv))}
    (jex,) = jsched.executors.values()
    real, plans = MHEngine.submit, []
    real_advance, layouts = dispatch._compiled_advance, []

    def submit(self, plan, **kw):
        plans.append((self, plan))
        return real(self, plan, **kw)

    def compiled_advance(*args, **kw):
        advance = real_advance(*args, **kw)

        def recorded(*a, layout=None, **k):
            layouts.append(layout)
            return advance(*a, layout=layout, **k)

        recorded.programs, recorded.eager = advance.programs, advance.eager
        return recorded

    dispatch._compiled_advance = compiled_advance
    try:
        sched = Scheduler(n_slots=4, randomness="fused", smoke=True, chunk_steps=6,
                          device="cpu")
        MHEngine.submit = submit
        done = sched.serve(burst(serving_pkg))
    finally:
        MHEngine.submit, dispatch._compiled_advance = real, real_advance
    (ex,) = sched.executors.values()
    assert len(ex.members) == 2
    # 3 chunks (6, 6, 4 steps), each slot 0 on gmm and slot 1 on ising
    assert layouts == [(0, 1, -1, -1)] * 3
    gmm, ising = (m.engine for m in ex.members)
    assert [(e, p.n_steps) for e, p in plans] == [(gmm, 6), (ising, 6)] * 2 + [
        (gmm, 4), (ising, 4)]
    assert all(isinstance(p.step0, torch.Tensor) and p.step0.ndim == 0 for _, p in plans)
    assert set(ex._advance.programs) == {(6, "all"), (4, "all")}
    assert sched.compiled_programs == jsched.compiled_programs == 2
    assert dispatch.jit_cache_size(ex._advance) == jdispatch.jit_cache_size(jex._advance)
    for r in done:
        assert_matches_solo(r, "fused")
        for f in ("samples", "final_words", "accept_count"):
            np.testing.assert_array_equal(getattr(r, f), np.asarray(getattr(want[r.rid], f)))


@pytest.mark.parametrize("workload,randomness,chunk,plan", [
    # (rid, seed, steps) admitted before each chunk; the third request
    # reuses the slot the second retires from
    ("gmm", "cim", 8, [[(0, 1, 48)], [(1, 2, 16)], [], [], [(2, 3, 32)]]),
    ("ising", "fused", 4, [[(0, 5, 32)], [(1, 6, 16)], [], [], [], [], [(2, 5, 32)]]),
])
def test_kernel_carry_is_written_in_place(workload, randomness, chunk, plan):
    """The kernel advance writes each segment's final words into the one
    carry tensor the executor holds for its life, across a mid-flight
    join, a retirement and the reuse of the freed slot; a retiring slot's
    payloads are copied behind its own segment, before the next one
    overwrites the carry (the finalize is deferred to the drain)."""
    ex = PackedExecutor.for_workload(workload, n_slots=2, randomness=randomness,
                                     execution="pallas", smoke=True, chunk_steps=chunk,
                                     pipeline_depth=16, device="cpu")
    carry = ex.words.tensor
    ptr = carry.data_ptr()
    reqs, slots, done = [], [], []
    for admits in plan:
        for rid, seed, n in admits:
            reqs.append(req(rid, workload, n, seed))
            slots.append(ex.admit(reqs[-1]))
        done.extend(ex.advance_chunk())
        assert ex.words.tensor is carry
    assert slots[2] == slots[1]  # the freed slot, reused
    assert {r.rid for r in done + run_to_completion(ex)} == {0, 1, 2}
    assert ex.words.tensor is carry and carry.data_ptr() == ptr
    for r in reqs:
        assert_matches_solo(r, randomness)


# --- the donation guard ------------------------------------------------------------


@pytest.mark.parametrize("execution", ["scan", "pallas"])
def test_stale_carry_read_raises(execution):
    """The carry handed to an advance is deleted: a reference taken
    before it raises on every read, and the request is untouched."""
    ex = make_executor(execution=execution)
    r = req(0, "gmm", 16, 2, "all")
    ex.admit(r)
    stale = ex.words
    ex.advance_chunk()
    assert stale.is_deleted() and not ex.words.is_deleted()
    with pytest.raises(RuntimeError):
        np.asarray(stale)
    with pytest.raises(RuntimeError):
        stale.tensor
    run_to_completion(ex)
    assert_matches_solo(r)


def test_carry_owns_its_storage():
    """The new carry is never a view of the segment's kept rows, so
    deleting it later leaves every kept row intact."""
    ex = make_executor("ising", chunk_steps=4, randomness="fused", execution="pallas")
    ex.admit(req(0, "ising", 12, 6))
    real, seen = ex._advance, []

    def advance(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    ex._advance = advance
    ex.advance_chunk()
    samples, words = seen[0][:2]
    assert words.untyped_storage().data_ptr() != samples.untyped_storage().data_ptr()


def test_mesh_under_pallas_is_refused():
    """A mesh shards only the scan executor's slot axis: under pallas
    execution it is refused with ``ValueError``, as in JAX (the sharded
    cases are in ``test_torch_serving_mesh.py``)."""
    sched = Scheduler(n_slots=2, smoke=True, mesh=object(), execution="pallas", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        sched.executor_for("gmm")
    with pytest.raises(ValueError, match="mesh"):
        PackedExecutor.for_workload("gmm", n_slots=2, smoke=True, execution="pallas",
                                    mesh=object(), device="cpu")


# --- the queue and the scheduler ---------------------------------------------------


def test_fifo_order_and_arrival_gating():
    q = FIFOQueue()
    q.push("a", 0.0)
    q.push("b", 1.0)
    assert q.pop_ready(0.5) == "a"
    assert q.pop_ready(0.5) is None
    assert q.next_arrival() == 1.0
    assert q.pop_ready(2.0) == "b"
    assert not q and q.next_arrival() is None


def test_fifo_push_front_keeps_turn():
    q = FIFOQueue()
    q.push("a")
    q.push("b")
    q.push_front(q.pop_ready())
    assert q.pop_ready() == "a"
    assert q.pop_ready() == "b"


def test_overflow_queue_is_fifo_and_bit_exact():
    sched = Scheduler(n_slots=1, smoke=True, chunk_steps=8, device="cpu")
    reqs = [req(1, "gmm", 48, 1, "last"), req(2, "gmm", 16, 2, "last"),
            req(3, "gmm", 32, 3, "last", t_arrive=0.05)]
    done = sched.serve(reqs)
    assert [r.rid for r in sorted(done, key=lambda r: r.t_admit)] == [1, 2, 3]
    for r in done:
        assert_matches_solo(r)
    summary = latency_summary(done)
    assert summary["n_requests"] == 3 and summary["requests_per_s"] > 0
    assert summary["p99_latency_s"] >= summary["p50_latency_s"]
    assert done[-1].t_admit >= 0.05  # the virtual clock skipped to its arrival
    assert latency_summary([]) == {"n_requests": 0}


def test_default_steps_and_validation():
    with pytest.raises(ValueError):
        ServeRequest(rid=0, collect="bogus")
    with pytest.raises(ValueError):
        ServeRequest(rid=0, n_steps=0)
    sched = Scheduler(n_slots=2, smoke=True, chunk_steps=8, device="cpu")
    r = ServeRequest(rid=0, workload="gmm", seed=1, collect="last")
    done = sched.serve([r])
    assert workloads.build("gmm", prng.PRNGKey(0), smoke=True, device="cpu").n_steps == \
        GMM_DEFAULT_STEPS
    assert_matches_solo(done[0], n_steps=GMM_DEFAULT_STEPS)


def test_segment_pipeline_depth():
    ran = []
    pipe = dispatch.SegmentPipeline(2)
    for i in range(4):
        pipe.push(lambda i=i: ran.append(i))
    assert ran == [0, 1]
    pipe.drain()
    assert ran == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        dispatch.SegmentPipeline(0)
