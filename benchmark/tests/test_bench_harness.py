"""The benchmark's harness on the CPU: its files, its yardstick, its checks.

    python -m pytest benchmark/tests -q -p no:cacheprovider -o addopts=""

The cells run here at a tiny size (``TINY``) on the port's plain path, where
the program and the reference compute the same; with the timed path broken
underneath, ``correct`` has to come out false. Tests marked ``gpu`` need a
CUDA device and skip without one (``test_bench_control_gpu.py``).
"""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness, opcount, roofline
from benchmark.reference.plain.ops import rasterize_pairs as plain_rp

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY_CONFIG = dict(grid=8, pairs_budget=20000, max_render_faces=1024, num_samples_x=2,
                   shadow_steps=4, triplane_resolution=16, triplane_components=8)
TINY_TRAFFIC = dict(resolution=32, views=4, chunk=2, envmap=[16, 32])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny_run(cell: str, trace: bool = False, seed: int = 2**31 + 77) -> dict:
    return harness.run_cell(cell, seed, 0.5, trace, torch.device("cpu"), 0.0,
                            config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC)


# ---- found by name ----------------------------------------------------------------


def test_spec_keys_names_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert [m["name"] for m in SPEC["end_to_end"]] == ["views_per_s", "peak_mem_gib", "setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    # a full check of 24 cells fits: 2 + 14 x 24 runs, each run_seconds + 60
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_from_its_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = harness.cell(cell)
    assert c["work"]["config"] == entry["config"]
    assert c["work"]["chips"] == entry["chips"] and c["work"]["why"] == entry["why"]
    assert hasattr(c["system"], "build") and c["traffic"]["mode"] in ("train", "relight")
    conf = next(x for x in SPEC["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"benchmark/configs/{entry['config']}.json"
    assert c["cfg"]["reduced"] == conf["reduced"] and c["cfg"]["source"] == conf["source"]
    ends = {m["name"] for m in SPEC["end_to_end"]}
    metrics = harness.layer_metrics(cell, ends)
    assert metrics and {m["name"] for m in metrics} == {
        m["name"] for m in SPEC["per_layer"] if cell in m["workloads"]}


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        assert path.exists(), path
        assert m["moves"] == "views_per_s" and set(m["workloads"]) <= set(CELLS)
        assert "def read(ctx" in path.read_text()


# ---- the yardstick ------------------------------------------------------------------


def test_kernel_counts_by_hand():
    """One 16 x 16 tile, two pairs of C = 1 covering it with no falloff:
    the first at opacity 0.5 (kept at every pixel), the second at 0.001,
    under 1/255 (walked, never kept)."""
    grid = plain_rp.tile_grid(16, 16, 16)
    pairs = torch.zeros((2, plain_rp.row_stride(1)))
    pairs[:, 0:2] = 8.0
    pairs[0, 5], pairs[1, 5] = 0.5, 0.001
    seg_start = torch.tensor([0, 2])
    _, _, n_contrib = plain_rp.composite_fwd_plain(pairs, seg_start, grid, 1)
    assert bool((n_contrib == 2).all())
    counts = roofline.pair_pixel_counts(pairs, seg_start, grid, n_contrib, kc=1)
    assert counts["walked_pair_pixels"] == 512 and counts["kept_pair_pixels"] == 256
    assert counts["tile_pair_pixels"] == 512 and counts["walked_pairs"] == 2
    assert counts["suffix_pair_pixels"] == 256 and counts["suffix_kept_pair_pixels"] == 0
    assert counts["multi_chunk_tiles"] == 1 and counts["max_pairs_per_tile"] == 2
    w = roofline.pass_work(pairs, seg_start, grid, 1, n_contrib, 2, kc=1)
    assert w["k1_chunk_products"]["ops"] == 512 * 16 + 256 * 2
    assert w["k1_composite_fwd"]["ops"] == 512 * 16 + 256 * (3 + 2 * 3)
    assert w["k2_chunk_suffix"]["ops"] == 256 * 16
    assert roofline.kept_ops("k2_composite_bwd", 3) == 25 + 10 + 4 + 10


def test_bound_and_op_counts_by_hand():
    # 3.35 GB at 3.35 TB/s is 1 ms; 67 GFLOP at 67 TFLOP/s is 1 ms
    assert roofline.bound_ms(3.35e9, 1.0) == pytest.approx((1.0, "bytes"))
    assert roofline.bound_ms(1.0, 134e9) == pytest.approx((2.0, "operations"))
    # trunk 26 x 32; one head 2 x (32 x 64 + 64 x 3)
    assert opcount.field_ops(32, 64, (3,), 1) == 832 + 4480
    t = opcount.shading_ops(10, 4, 2)
    assert t == {"sphere_trace": 2 * 4 * 10 * 2 * 88, "sampling": 4 * 10 * 162,
                 "mc_eval": 4 * 10 * 300}
    work = dict(shaded_points=10, samples=4, shadow_steps=2, field_points=5,
                field_ops_per_point=7, k1_ops=11, k2_ops=13)
    fwd = opcount.view_ops(work, training=False)
    assert fwd["total"] == sum(t.values()) + 35 + 11
    train = opcount.view_ops(work, training=True)
    assert train["total"] == fwd["total"] + 2 * (t["mc_eval"] + 35) + 13


def test_trace_reduction_by_hand():
    from benchmark.trace import Trace

    device = [("k_a", 100, 10, 5), ("k_b", 120, 30, 15), ("k_c", 200, 50, 60),
              ("k_b", 300, 20, 70)]
    host = [("span.x", 0, 20, True), ("span.y", 50, 30, True), ("aten::op", 150, 60, False)]
    t = Trace(device, host, window_s=400e-9)
    assert t.busy_s == pytest.approx(110e-9)
    assert t.span_device_s("span.x") == pytest.approx(40e-9)
    assert t.span_device_s("span.y") == pytest.approx(70e-9)
    assert t.span_device_s("span.z") is None
    assert t.last_launches("k_b") == [pytest.approx(20e-9)]
    assert t.device_ops()[0] == ["k_b", pytest.approx(50e-9)]


# ---- the reference and the result line ------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_plain_path(cell):
    out = tiny_run(cell)
    assert out["correct"] is True, out["checks"]
    assert all(v["value"] == 0 for v in out["checks"].values()), out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "step_s",
                         "checks"]
    ends = [m["name"] for m in SPEC["end_to_end"]]
    assert list(out["metrics"]) == ends
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_result_line():
    out = tiny_run("defer_s4r.relight800", trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "step_s", "checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    # no device ran anything: no device metric is read from a CPU run
    assert out["metrics"] == {}


# ---- faults underneath the timed path ---------------------------------------------------


@pytest.mark.parametrize("cell", ["mc_s4r.train800", "defer_s4r.train800"])
def test_state_left_unchanged_is_not_correct(cell):
    with faults.state_unchanged():
        out = tiny_run(cell)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_altered_answer_is_not_correct():
    with faults.answer_altered():
        out = tiny_run("defer_s4r.relight800")
    assert out["correct"] is False


# ---- what the benchmark imports ------------------------------------------------------------


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib by name: a dotted module path in a string
            if re.fullmatch(r"[A-Za-z_][\w]*(\.[\w]+)+", node.value):
                tops.add(node.value.split(".")[0])
    return tops


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = _imported_tops(path)
        assert not tops & {"jax", "jaxlib", "flax", "geosplatting_tpu"}, (path, tops)
    for path in (BENCH / "reference").rglob("*.py"):
        assert "geosplatting_tpu_torch" not in _imported_tops(path), path


def test_no_result_without_a_card(tmp_path):
    """Where there is no CUDA device, or only BENCHMARK.json and the
    benchmark's files: a non-zero exit and no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                            "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                           cwd=cwd, capture_output=True, text=True, timeout=300,
                           env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0 and r.stdout.strip() == "", (r.returncode, r.stdout)
