"""Roofline analysis over the dry-run reports — the port of
``repro.launch.roofline``.

Per (arch x shape x mesh) cell, from the report ``launch/dryrun.py``
wrote:

  compute term    = FLOPs_per_device / peak_FLOP/s_per_card
  memory term     = bytes_per_device / HBM_bw_per_card
  collective term = effective_collective_bytes_per_device / link bw

The dry run counts on each rank's local tensors, so its numbers are
already per device.  Collective bytes carry per-kind algorithm factors
(ring all-reduce moves ~2x the payload; all-gather / reduce-scatter
~1x), as in the JAX package.

Hardware constants: the NVIDIA H100 SXM 80GB datasheet at 700 W, 989e12
FLOP/s dense bfloat16 and 3.35e12 B/s HBM3.  The collective term is an
assumption: a mesh axis whose ranks share an 8-card NVLink node moves
450e9 B/s a direction (NVLink 4), an axis that spans nodes 50e9 B/s (one
400 Gb/s NIC per card).  Ranks are numbered row-major over the mesh and
a node holds 8 consecutive ranks, so an axis stays inside a node when
the product of its extent and the extents after it is at most 8; the
collectives are not split by axis, so the term takes the slowest link
any axis with more than one rank crosses.

MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = params (active for
MoE), D = tokens processed per step (the report's shape, else
``configs.SHAPES``); the ratio
MODEL_FLOPS / global FLOPs flags recompute and redundancy (>1 is
impossible; ~0.3 means 3x overhead from remat + attention + non-matmul
work).

Usage:
  python -m repro_torch.launch.roofline                 # 16x16 reports table
  python -m repro_torch.launch.roofline --mesh pod2_16x16
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs

PEAK_FLOPS = 989e12         # bf16 dense / card (H100 SXM 80GB, 700 W)
HBM_BW = 3.35e12            # B/s / card (HBM3)
NVLINK_BW = 450e9           # B/s a direction / card, inside an 8-card node (assumed)
NIC_BW = 50e9               # B/s / card across nodes, one 400 Gb/s NIC (assumed)
NODE_CARDS = 8

# effective bytes multipliers per collective kind (ring algorithms)
ALGO_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch"
)


def effective_collective_bytes(coll: dict) -> float:
    return sum(
        coll.get(kind, 0) * fac for kind, fac in ALGO_FACTOR.items()
    )


def link_bw(mesh: str) -> float:
    """The collective term's bandwidth for a mesh written ``"AxB[xC]"``:
    NVLink when every axis of more than one rank stays inside a node,
    else the NIC."""
    sizes = [int(x) for x in mesh.split("x")]
    for i, n in enumerate(sizes):
        inner = 1
        for m in sizes[i:]:
            inner *= m
        if n > 1 and inner > NODE_CARDS:
            return NIC_BW
    return NVLINK_BW


def analyse(report: dict) -> dict:
    """Attach roofline terms to one dry-run report."""
    if report.get("status") != "ok":
        return dict(report)
    hc = report["hlo_cost"]
    flops = hc["flops"]
    bytes_acc = hc["bytes"]
    bytes_upper = hc.get("bytes_upper", hc["bytes"])
    coll_eff = effective_collective_bytes(hc.get("collectives", {}))
    chips = report["chips"]

    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = coll_eff / link_bw(report["mesh"])
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    # MODEL_FLOPS: useful math per step
    n_params = (
        report["param_count_active"]
        if report["param_count_active"] != report["param_count"]
        else report["param_count"]
    )
    # the port's reports carry their shape; JAX's name one of configs.SHAPES
    shape = configs.SHAPES.get(report["shape"])
    seq = report.get("seq_len") or shape.seq_len
    batch = report.get("global_batch") or shape.global_batch
    tokens = (1 if report["kind"] == "decode" else seq) * batch
    mult = 6 if report["kind"] == "train" else 2
    model_flops = mult * n_params * tokens
    flops_global = flops * chips
    useful = model_flops / flops_global if flops_global else 0.0

    bound_time = max(terms.values())
    out = dict(report)
    out["roofline"] = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "memory_upper_s": bytes_upper / HBM_BW,
        "collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_global": flops_global,
        "useful_flops_ratio": useful,
        # fraction of roofline: useful work rate vs card peak if running at
        # the dominant-term time
        "roofline_fraction": (
            model_flops / chips / PEAK_FLOPS / bound_time if bound_time else 0.0
        ),
    }
    return out


def load_reports(mesh_tag: str, tag: str | None = None, artifact_dir: str | None = None):
    pat = os.path.join(artifact_dir or ARTIFACT_DIR, mesh_tag, "*.json")
    reports = []
    for path in sorted(glob.glob(pat)):
        base = os.path.basename(path)[: -len(".json")]
        parts = base.split("__")
        if tag is None and len(parts) > 2:
            continue  # perf-iteration report, not baseline
        if tag is not None and (len(parts) < 3 or parts[2] != tag):
            continue
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def table(reports) -> str:
    rows = [
        (
            "arch",
            "shape",
            "dom",
            "compute_ms",
            "memory_ms",
            "coll_ms",
            "useful",
            "roofline%",
        )
    ]
    for r in reports:
        a = analyse(r)
        if a.get("status") != "ok":
            rows.append((a["arch"], a["shape"], a.get("status"), "-", "-", "-", "-", "-"))
            continue
        rl = a["roofline"]
        rows.append(
            (
                a["arch"],
                a["shape"],
                rl["dominant"][:4],
                f"{rl['compute_s'] * 1e3:9.3f}",
                f"{rl['memory_s'] * 1e3:9.3f}",
                f"{rl['collective_s'] * 1e3:9.3f}",
                f"{rl['useful_flops_ratio']:6.3f}",
                f"{rl['roofline_fraction'] * 100:6.2f}",
            )
        )
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    lines = [
        "  ".join(str(c).rjust(w) for c, w in zip(row, widths)) for row in rows
    ]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--dir", default=None, help="report directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    reports = load_reports(args.mesh, args.tag, args.dir)
    if not reports:
        print(f"no reports under {args.dir or ARTIFACT_DIR}/{args.mesh}")
        return
    print(table(reports))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([analyse(r) for r in reports], f, indent=1)


if __name__ == "__main__":
    main()
