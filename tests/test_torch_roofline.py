"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's (``repro.launch.roofline``, which imports no JAX).

Both analyse the same report in the JAX format: the useful work and its
share equal JAX's, and the terms differ by the constants only (the H100
SXM 80GB datasheet's 989e12 FLOP/s and 3.35e12 B/s against JAX's TPU
figures; the collective term's link is an assumption stated in the
module).
"""

import json

import pytest

from repro.launch import roofline as jroof
from repro_torch.launch import roofline


def _report(shape="decode_32k", mesh="16x16", chips=256, kind="decode", status="ok",
            arch="granite-3-8b"):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "chips": chips, "kind": kind,
        "status": status, "param_count": 8_170_000_000, "param_count_active": 8_170_000_000,
        "cost_analysis": {"flops": 1.0, "bytes_accessed": 1.0},
        "collectives": {"all-reduce": 5.0, "total": 5.0, "count": 1},
        "hlo_cost": {"flops": 2.39e10, "bytes": 2.97e10, "bytes_upper": 4.55e10,
                     "collectives": {"all-gather": 2.7e7, "all-reduce": 5.3e6,
                                     "reduce-scatter": 2.6e6, "total": 3.5e7},
                     "unknown_trip_loops": 0},
    }


CASES = [("train_4k", "train"), ("prefill_32k", "prefill"), ("decode_32k", "decode"),
         ("long_500k", "decode")]


@pytest.mark.parametrize("shape,kind", CASES)
def test_analyse_matches_jax(shape, kind):
    moe = dict(_report(shape=shape, kind=kind), param_count_active=3_300_000_000)
    for report in (_report(shape=shape, kind=kind), moe):
        got, want = roofline.analyse(report)["roofline"], jroof.analyse(report)["roofline"]
        assert got["model_flops"] == want["model_flops"]
        assert got["hlo_flops_global"] == want["hlo_flops_global"]
        assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
        assert got["compute_s"] * 989e12 == pytest.approx(want["compute_s"] * 197e12, rel=1e-15)
        assert got["memory_s"] * 3.35e12 == pytest.approx(want["memory_s"] * 819e9, rel=1e-15)
        assert got["memory_upper_s"] * 3.35e12 == pytest.approx(
            want["memory_upper_s"] * 819e9, rel=1e-15)
        # a 16 x 16 mesh spans nodes: the NIC's 50e9 B/s, JAX's ICI figure
        assert got["collective_s"] == want["collective_s"]


def test_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert (roofline.NVLINK_BW, roofline.NIC_BW, roofline.NODE_CARDS) == (450e9, 50e9, 8)
    assert roofline.ALGO_FACTOR == jroof.ALGO_FACTOR
    coll = {"all-reduce": 3, "all-gather": 5, "reduce-scatter": 7, "all-to-all": 11,
            "collective-permute": 13, "total": 39}
    assert roofline.effective_collective_bytes(coll) == jroof.effective_collective_bytes(coll)


@pytest.mark.parametrize("mesh,bw", [
    ("1x1", 450e9), ("2x2", 450e9), ("1x8", 450e9), ("8x1", 450e9), ("2x4", 450e9),
    ("2x8", 50e9), ("1x16", 50e9), ("16x16", 50e9), ("2x16x16", 50e9), ("2x1x4", 450e9),
])
def test_link_bandwidth(mesh, bw):
    """An axis inside an 8-card node (its extent times the extents after
    it at most 8) moves over NVLink; one that spans nodes over the NIC."""
    assert roofline.link_bw(mesh) == bw


def test_collective_term_on_one_node():
    got = roofline.analyse(_report(mesh="2x4", chips=8))["roofline"]
    assert got["collective_s"] == (2.7e7 + 2 * 5.3e6 + 2.6e6) / 450e9
    assert got["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda k: got[f"{k}_s"])


def test_reports_table_and_main(tmp_path, capsys):
    d = tmp_path / "16x16"
    d.mkdir()
    reports = {
        "granite-3-8b__decode_32k": _report(),
        "granite-3-8b__train_4k": _report(shape="train_4k", kind="train"),
        "granite-3-8b__long_500k": dict(_report(shape="long_500k"), status="skipped"),
        "granite-3-8b__decode_32k__perf": _report(),
    }
    for name, r in reports.items():
        (d / f"{name}.json").write_text(json.dumps(r))
    base = roofline.load_reports("16x16", artifact_dir=str(tmp_path))
    assert [r["shape"] for r in base] == ["decode_32k", "long_500k", "train_4k"]
    assert [r["shape"] for r in roofline.load_reports("16x16", "perf", str(tmp_path))] == [
        "decode_32k"]
    lines = roofline.table(base).splitlines()
    assert lines[0].split() == ["arch", "shape", "dom", "compute_ms", "memory_ms", "coll_ms",
                                "useful", "roofline%"]
    assert lines[2].split()[2:] == ["skipped", "-", "-", "-", "-", "-"]
    out = tmp_path / "out.json"
    roofline.main(["--dir", str(tmp_path), "--json-out", str(out)])
    assert capsys.readouterr().out == roofline.table(base) + "\n"
    assert [r.get("roofline", {}).get("model_flops") for r in json.loads(out.read_text())] == [
        roofline.analyse(r).get("roofline", {}).get("model_flops") for r in base]
    roofline.main(["--dir", str(tmp_path), "--mesh", "pod2_16x16"])
    assert "no reports under" in capsys.readouterr().out
