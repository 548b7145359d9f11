"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake mesh
— the port of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory and cost analyses and the compiled HLO.
PyTorch compiles nothing ahead of a step, so the port runs the step
itself, once, on stand-ins that allocate nothing:

  * a ``"fake"`` process group of the mesh's world size (256 for the
    (16, 16) production mesh, 512 for (2, 16, 16)) in this one process,
    as rank 0: its collectives move nothing;
  * the mesh from ``launch/mesh.py`` (``make_production_mesh`` or
    ``alt_mesh``) on it, and under a ``FakeTensorMode`` the model
    (``lm.abstract_params``) placed by ``sharding.distribute_params``
    under ``rules_for_config``, the AdamW state on its ZeRO axes
    (``rules_with_zero``), the error state under ``--compress-pods``, and
    the batch and cache (``configs.batch_specs`` / ``cache_specs``);
  * one step of the cell's kind (``make_train_step``: forward, backward
    and update; ``make_prefill_step``; ``make_decode_step``;
    ``make_decode_sample_step``, whose MH chain is the operator
    ``repro_torch::mh_chain`` and reaches its fake implementation on the
    card) under one dispatch mode, ``hlo_cost.CostCounter`` (FLOPs, bytes
    and ``hlo_analysis``'s collective bytes per device), through which
    ``PeakTracker`` sees the same ops (the live bytes of this rank's
    storages).

Per cell this writes ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``
with the JAX report's keys: ``memory_analysis`` (per-device
``argument_size_bytes``: parameters, optimiser state, batch, cache and
error state as this rank holds them; ``output_size_bytes``;
``temp_size_bytes``, the peak of live bytes less the arguments;
``alias_size_bytes``, outputs written in place into an argument, the
cache and the trained parameters; ``generated_code_bytes``, 0),
``cost_analysis`` (the counted FLOPs and mandatory bytes), ``hlo_cost``
and ``collectives``, and ``trace_s`` in place of ``lower_s`` and
``compile_s``.  ``hlo_gz`` and ``hlo_bytes`` have no counterpart: there
is no HLO.  The port hands every rank the global batch (the model cuts
its rows), so a batch counts whole in the arguments; its int32 tokens
are int64 here.  ``argument_bytes`` breaks the arguments down by input;
``collective_ops`` lists each collective's kind, operand bytes, operand
shape and the parameter the operand is made from (None for activations
and other state).

Entry points run on the card unless ``--device cpu`` is asked for; the
fake tensors live on that device and nothing is allocated on it.  Each
cell prints the process's max RSS: a full-size cell stays within the
host memory of the Python objects.

Usage:
  python -m repro_torch.launch.dryrun --all                  # 40 cells, 1 pod
  python -m repro_torch.launch.dryrun --all --multi-pod      # 40 cells, 2 pods
  python -m repro_torch.launch.dryrun --arch granite_34b --shape train_4k
  python -m repro_torch.launch.dryrun --arch granite3_8b --shape decode_32k --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import resource
import time
import traceback
import weakref

import torch

from repro_torch import configs
from repro_torch.distributed.hlo_analysis import LocalOpMode, dtensor_bookkeeping
from repro_torch.distributed.hlo_cost import CostCounter

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")


# --- per-device bytes ------------------------------------------------------------


def _leaves(tree):
    """The tensors of nested dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree) -> dict:
    """``{storage key: storage}`` of the storages this rank holds for the
    tensors of ``tree`` (a storage shared by views counts once)."""
    out = {}
    for t in _leaves(tree):
        st = _local(t).untyped_storage()
        out[st._cdata] = st
    return out


def local_bytes(tree) -> int:
    return sum(st.nbytes() for st in _storages(tree).values())


class PeakTracker(LocalOpMode):
    """The peak of live bytes of this rank's storages while a step runs:
    the arguments' storages (``hold``) and every storage an op makes,
    each counted until its finalizer runs."""

    def __init__(self, also=()):
        super().__init__(also)
        self.live: dict = {}
        self.current = 0
        self.peak = 0

    def hold(self, tree) -> None:
        for t in _leaves(tree):
            self._track(_local(t).untyped_storage())

    def _track(self, st) -> None:
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.current -= self.live.pop(key, 0)

    def on_op(self, func, args, kwargs, out) -> None:
        for t in _leaves(out):
            if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
                continue
            self._track(t.untyped_storage())


def max_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_bytes() -> int:
    """This process's resident bytes now (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


# --- the fake mesh ---------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks in this process
    (rank 0): collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_for(mesh_arg: str | None, multi_pod: bool, device: str):
    """(mesh builder, report tag, world size) for the CLI's ``--mesh`` /
    ``--multi-pod``; call the builder inside ``fake_group(world size)``."""
    from repro_torch.launch.mesh import alt_mesh, make_production_mesh

    if mesh_arg:
        data, model = (int(x) for x in mesh_arg.split("x"))
        pods = 2 if multi_pod else 1
        tag = ("pod2_" if multi_pod else "") + mesh_arg
        return (lambda: alt_mesh(data, model, pods=pods, device_type=device)), tag, \
            pods * data * model
    tag = "pod2_16x16" if multi_pod else "16x16"
    return (lambda: make_production_mesh(multi_pod=multi_pod, device_type=device)), tag, \
        512 if multi_pod else 256


# --- one cell --------------------------------------------------------------------


def _zero_placed(opt: dict, model, axes_tree, rules) -> dict:
    """The AdamW moments on their ZeRO axes (``opt_state_axes`` under
    ``rules_with_zero``), as the JAX dry run shards them."""
    from repro_torch.distributed.sharding import rules_with_zero, shard
    from repro_torch.optim import opt_state_axes

    axes = opt_state_axes(model, axes_tree)
    zrules = rules_with_zero(rules)
    for part in ("m", "v"):
        opt[part] = {n: shard(t, axes[part][n], zrules) for n, t in opt[part].items()}
    return opt


def trace_cell(
    cfg,
    shape_name: str,
    mesh,
    *,
    device: str = "cuda",
    variant: str = "baseline",
    compress_pods: bool = False,
    decode_sample: bool = False,
):
    """Trace one cell's step on fake tensors; returns the report dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import prng
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import (
        distribute_params,
        rules_for_config,
        use_mesh,
        use_rules,
    )
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import step as steps

    shape = configs.SHAPES[shape_name]
    rules = rules_for_config(cfg)
    rss_before = rss_bytes()
    report: dict = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in tuple(mesh.mesh.shape)),
        "mesh_axes": list(mesh.mesh_dim_names),
        "chips": mesh.size(),
        "variant": variant,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
        "device": device,
    }
    with dtensor_bookkeeping(), FakeTensorMode(), use_mesh(mesh), use_rules(rules):
        model, axes_tree = lm.abstract_params(cfg, device)
        distribute_params(model, mesh)
        batch = configs.batch_specs(cfg, shape, device)
        inputs = {"params": model, "batch": batch}
        if shape.kind == "train":
            opt_cfg = AdamWConfig()
            inputs["opt"] = _zero_placed(adamw_init(model, opt_cfg), model, axes_tree, rules)
            step = steps.make_train_step(
                cfg, axes_tree, opt_cfg, mesh=mesh,
                step_cfg=steps.TrainStepConfig(n_micro=cfg.train_microbatches,
                                               compress_pods=compress_pods))
            args = (model, inputs["opt"], batch)
            if compress_pods:
                inputs["err"] = compression.init_error_state(dict(model.named_parameters()))
                args += (inputs["err"],)
        else:
            inputs["cache"] = configs.cache_specs(cfg, shape, device)
            if shape.kind == "prefill":
                step = steps.make_prefill_step(cfg)
                args = (model, batch, inputs["cache"])
            elif decode_sample:  # the paper's technique fused into the decode step
                step = steps.make_decode_sample_step(cfg)
                inputs["key"] = prng.PRNGKey(0, device=device)
                args = (model, batch["tokens"], inputs["cache"], inputs["key"])
            else:
                step = steps.make_decode_step(cfg)
                args = (model, batch["tokens"], inputs["cache"])
        arg_storages = _storages(inputs)
        arg_bytes = sum(st.nbytes() for st in arg_storages.values())
        # held weakly: a storage the step frees (a replaced moment) may
        # leave its key to a new one
        arg_refs = {k: weakref.ref(st) for k, st in arg_storages.items()}
        report["argument_bytes"] = {k: local_bytes(v) for k, v in inputs.items()}
        peak = PeakTracker()
        peak.hold(inputs)
        del arg_storages

        t0 = time.time()
        with CostCounter(also=(peak,), weights=dict(model.named_parameters())) as cost:
            out = step(*args)
        trace_s = time.time() - t0
        out_storages = _storages(out)
        out_bytes = sum(st.nbytes() for st in out_storages.values())
        alias_bytes = sum(st.nbytes() for k, st in out_storages.items()
                          if k in arg_refs and arg_refs[k]() is st)
        del out, out_storages, step, args, inputs, model, batch

    hc = cost.report()
    report["memory_analysis"] = {
        "argument_size_bytes": arg_bytes,
        "output_size_bytes": out_bytes,
        "temp_size_bytes": peak.peak - arg_bytes,
        "alias_size_bytes": alias_bytes,
        "generated_code_bytes": 0,
    }
    report["cost_analysis"] = {"flops": hc["flops"], "bytes_accessed": hc["bytes"]}
    report["collectives"] = {**hc["collectives"], "count": len(cost.coll)}
    report["collective_ops"] = [list(r) for r in cost.coll]
    report["hlo_cost"] = hc
    report["custom_ops"] = dict(cost.custom)  # custom operators reached (JAX's custom-calls)
    report["trace_s"] = round(trace_s, 2)
    report["rss_bytes_before"] = rss_before
    report["max_rss_bytes"] = max_rss_bytes()
    if device == "cuda":  # the fake tensors took nothing on the card
        report["device_allocated_bytes"] = torch.cuda.memory_allocated()
    report["status"] = "ok"
    mem = report["memory_analysis"]
    print(
        f"[dryrun] {cfg.name} x {shape_name} x {report['mesh']} ({variant}): OK  "
        f"trace={trace_s:.1f}s flops={hc['flops']:.3e} "
        f"coll={hc['collectives'].get('total', 0):.3e}B"
    )
    print(f"  memory: argument={mem['argument_size_bytes'] / 1e9:.4f} GB "
          f"temp={mem['temp_size_bytes'] / 1e9:.4f} GB "
          f"output={mem['output_size_bytes'] / 1e9:.4f} GB "
          f"alias={mem['alias_size_bytes'] / 1e9:.4f} GB per device; "
          f"RSS {rss_before / 1e9:.3f} GB before, max {report['max_rss_bytes'] / 1e9:.3f} GB")
    print(f"  cost: flops={hc['flops']:.4e} bytes={hc['bytes']:.4e} "
          f"bytes_upper={hc['bytes_upper']:.4e} collectives={hc['collectives']}")
    return report


def run_cell(arch: str, shape_name: str, mesh, variant="baseline", cfg=None, **kw):
    cfg = cfg or configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        print(f"[dryrun] {arch} x {shape_name}: SKIP ({reason})")
        return {
            "arch": cfg.name,
            "shape": shape_name,
            "variant": variant,
            "status": "skipped",
            "reason": reason,
        }
    try:
        return trace_cell(cfg, shape_name, mesh, variant=variant, **kw)
    except Exception as e:  # a failing cell is a bug — surface it loudly
        traceback.print_exc()
        return {
            "arch": cfg.name,
            "shape": shape_name,
            "variant": variant,
            "status": "failed",
            "error": f"{type(e).__name__}: {e}",
        }


def save_report(report: dict, mesh_tag: str, tag: str | None = None, out_dir=None):
    d = os.path.join(out_dir or ARTIFACT_DIR, mesh_tag)
    os.makedirs(d, exist_ok=True)
    arch = report["arch"].replace("/", "_")
    name = f"{arch}__{report['shape']}"
    if tag:
        name += f"__{tag}"
    path = os.path.join(d, name + ".json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path


def main(argv=None):
    from repro_torch.samplers.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="arch id (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", help="shape name", choices=list(configs.SHAPES))
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--multi-pod", action="store_true", help="use the (2,16,16) mesh")
    ap.add_argument("--mesh", help="override mesh as DATAxMODEL, e.g. 32x8")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--tag", help="artifact filename suffix (perf iterations)")
    ap.add_argument("--seq-shard", action="store_true", help="enable SP override")
    # §Perf hillclimb levers
    ap.add_argument("--n-micro", type=int, help="override train microbatches")
    ap.add_argument("--capacity-factor", type=float, help="MoE capacity factor")
    ap.add_argument("--cache-dtype", help="decode cache dtype (e.g. float8_e4m3fn)")
    ap.add_argument("--remat", help="remat policy: nothing|dots|none")
    ap.add_argument("--attn-causal-skip", action="store_true")
    ap.add_argument("--logits-chunk", type=int)
    ap.add_argument("--decode-sample", action="store_true",
                    help="trace the MCMC-sampling decode step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (default: the card)")
    ap.add_argument("--out-dir", help="report directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type

    make_mesh, mesh_tag, world = mesh_for(args.mesh, args.multi_pod, device)
    cells = (
        [(a, s) for a, s, _, _ in configs.assigned_cells()]
        if args.all
        else [(args.arch, args.shape)]
    )
    reports = []
    with fake_group(world):
        mesh = make_mesh()
        for arch, shape in cells:
            cfg = configs.get_config(arch)
            patch = {}
            if args.seq_shard:
                patch["seq_shard"] = True
            if args.n_micro:
                patch["train_microbatches"] = args.n_micro
            if args.capacity_factor:
                patch["moe_capacity_factor"] = args.capacity_factor
            if args.cache_dtype:
                patch["cache_dtype_str"] = args.cache_dtype
            if args.remat:
                patch["remat_policy"] = args.remat
            if args.attn_causal_skip:
                patch["attn_causal_skip"] = True
            if args.logits_chunk:
                patch["logits_chunk"] = args.logits_chunk
            if patch:
                cfg = dataclasses.replace(cfg, **patch)
            report = run_cell(
                arch, shape, mesh,
                variant=args.tag or "baseline",
                cfg=cfg,
                device=device,
                compress_pods=args.compress_pods,
                decode_sample=args.decode_sample,
            )
            report["path"] = save_report(report, mesh_tag, tag=args.tag, out_dir=args.out_dir)
            reports.append(report)
        del mesh
    n_ok = sum(r["status"] == "ok" for r in reports)
    n_skip = sum(r["status"] == "skipped" for r in reports)
    n_fail = sum(r["status"] == "failed" for r in reports)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)
    return reports


if __name__ == "__main__":
    main()
