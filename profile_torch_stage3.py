#!/usr/bin/env python3
"""Where one stage-3 train step of the PyTorch port spends its time, on one GPU.

    python3 profile_torch_stage3.py [--steps 2] [--seed 0] [--out summary.json]

Builds stage 3 at the s4r-twosphere preset's widths from a stage-2 export
of a GeoSplatterMC (grid 96, scene scale 1.0, 2^17 render faces, its SDF a
sphere of radius 0.45, random weights from --seed; compacted as the stage-2
task exports it): GeoSplatterDefer with pairs budget 1.6M, 8 x 8 Monte-Carlo
sample steps per pixel, 24-step SDF shadows and the train task's mesh tile
capacity; 8 orbit cameras at 800x800 and the analytic-sphere ground truth;
GeoSplatDeferTrainer. It runs one step to warm up, then prints, one JSON
line each:
1. the timed steps: host clock around ``--steps`` synchronised steps, and
   the peak device memory;
2. the split: one more step with every piece synchronised and timed on the
   host clock (the mesh raster, the G-buffer's and the kd map's
   rasterization forward, the sampling, the sphere trace, the Monte-Carlo
   loop forward and its recomputation in the backward, the ks predictor,
   the rest of the forward and of the backward, the update); the
   synchronisation removes what overlap there was, so the split step is
   slower than a timed one;
3. the trace: ``torch.profiler`` over one camera's forward and backward:
   wall time, the device's busy time and idle share, the device time under
   each span of the port, the kernels K1-K3, and the 25 kernels with the
   most device time.
The last line is the summary, which ``--out`` also writes to a file.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import phase, sphere_gt
from profile_torch_stage2 import Split

CONFIG = dict(grid=96, scene_scale=1.0, cameras=8, resolution=800, pairs_budget=1_600_000,
              max_render_faces=1 << 17, num_samples_x=8, shadow_steps=24, sdf_radius=0.45)
SPANS = ("trainer.forward", "trainer.backward", "trainer.apply_grads", "defer.ks",
         "defer.gbuffer", "defer.mesh_raster", "defer.attribute", "envshade.sample",
         "envshade.visibility", "envshade.mc_step", "rasterize.bin_pairs", "rasterize.composite")


def build(device, seed: int):
    """(trainer, cameras, ground truth, generator) of stage 3 at the
    s4r-twosphere widths."""
    import torch

    from geosplatting_tpu_torch.engine.train_task import MESH_TILE_CAPACITY
    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
    from geosplatting_tpu_torch.models.geosplat_mc import (
        GeoSplatterMC, compact_export, export_stage1,
    )
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
        GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
    )

    c = CONFIG
    gen = torch.Generator(device=device).manual_seed(seed)
    stage1 = GeoSplatter(resolution=c["grid"], scale=c["scene_scale"], generator=gen,
                         device=device)
    with torch.no_grad():
        stage1.sdf.copy_(torch.linalg.norm(stage1.grid.base_vertices(device), dim=-1)
                         - c["sdf_radius"])
    stage2 = GeoSplatterMC(resolution=c["grid"], scale=c["scene_scale"],
                           max_render_faces=c["max_render_faces"], generator=gen, device=device)
    stage2.init_from_stage1(export_stage1(stage1))
    export = compact_export(stage2.export_model())
    del stage1, stage2
    model = GeoSplatterDefer(
        num_gaussians=export["means"].shape[0], ks_resolution=export["ks_enc"]["planes"].shape[1],
        ks_components=export["ks_enc"]["planes"].shape[-1], resolution=c["grid"],
        scale=c["scene_scale"], num_samples_x=c["num_samples_x"],
        shadow_steps=c["shadow_steps"], pairs_budget=c["pairs_budget"],
        mesh_tile_capacity=MESH_TILE_CAPACITY, device=device)
    model.init_from_stage2(export)
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=20.0,
                              num_samples=c["cameras"], width=c["resolution"],
                              height=c["resolution"], device=device)
    trainer = GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=c["cameras"]), model)
    return trainer, cams, sphere_gt(cams), gen


def split_step(trainer, cams, gt, gen) -> dict:
    import torch

    from geosplatting_tpu_torch.models import geosplat_defer
    from geosplatting_tpu_torch.ops import envshade
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import GeoSplatDeferTrainer

    sp = Split()
    make_vis = geosplat_defer.make_sdf_visibility

    def timed_visibility(*args, **kw):
        vis = make_vis(*args, **kw)

        def traced(origins, dirs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = vis(origins, dirs)
            torch.cuda.synchronize()
            sp.add("sphere_trace", time.perf_counter() - t0)
            return out

        return traced

    fwd = GeoSplatDeferTrainer._local_loss

    def forward(self, *args, **kw):
        sp.in_forward = True
        try:
            return fwd(self, *args, **kw)
        finally:
            sp.in_forward = False

    sp.patched.append((GeoSplatDeferTrainer, "_local_loss", fwd))
    GeoSplatDeferTrainer._local_loss = forward
    sp.patched.append((geosplat_defer, "make_sdf_visibility", make_vis))
    geosplat_defer.make_sdf_visibility = timed_visibility
    raster = geosplat_defer.GeoSplatterDefer._rasterize

    def labelled(self, colors, *args, **kw):
        label = "gbuffer_forward" if colors.shape[-1] == 14 else "kd_map_forward"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = raster(self, colors, *args, **kw)
        torch.cuda.synchronize()
        sp.add(label, time.perf_counter() - t0)
        return out

    sp.patched.append((geosplat_defer.GeoSplatterDefer, "_rasterize", raster))
    geosplat_defer.GeoSplatterDefer._rasterize = labelled
    sp.wrap(GeoSplatDeferTrainer, "_local_loss", "forward")
    sp.wrap(torch.Tensor, "backward", "backward")
    sp.wrap(GeoSplatDeferTrainer, "_apply_grads", "apply_grads")
    sp.wrap(geosplat_defer, "rasterize_mesh", "mesh_raster")
    sp.wrap(geosplat_defer, "interpolate", "mesh_interpolate")
    sp.wrap(geosplat_defer.GeoSplatterDefer, "gaussian_ks", "ks_predictor")
    sp.wrap(envshade, "_draw_samples", "sampling_and_trace")
    sp.wrap(envshade, "_mc_step",
            lambda: "mc_loop_forward" if sp.in_forward else "mc_loop_recompute")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(cams, gt, generator=gen)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        sp.restore()
    r = {k: v["seconds"] for k, v in sp.rows.items()}
    inner = ("mesh_raster", "mesh_interpolate", "gbuffer_forward", "kd_map_forward",
             "ks_predictor", "sampling_and_trace", "mc_loop_forward")
    return {
        "split_step_s": total,
        "mesh_raster_s": r["mesh_raster"] + r["mesh_interpolate"],
        "gbuffer_forward_s": r["gbuffer_forward"], "kd_map_forward_s": r["kd_map_forward"],
        "sampling_s": r["sampling_and_trace"] - r["sphere_trace"],
        "sphere_trace_s": r["sphere_trace"],
        "mc_loop_forward_s": r["mc_loop_forward"],
        "mc_loop_recompute_s": r.get("mc_loop_recompute", 0.0),
        "ks_predictor_s": r["ks_predictor"],
        "forward_other_s": r["forward"] - sum(r[k] for k in inner),
        "backward_other_s": r["backward"] - r.get("mc_loop_recompute", 0.0),
        "apply_grads_s": r["apply_grads"],
        "calls": {k: v["calls"] for k, v in sp.rows.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_stage3: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    trainer, cams, gt, gen = build(device, args.seed)

    def step(i: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(cams, gt, generator=gen)
        torch.cuda.synchronize()
        if int(m["nonfinite_grads"]) != 0 or not (float(m["pair_fill"]) <= 1.0
                                                  and m["mesh_tile_fill"] <= 1.0):
            raise AssertionError(f"step {i}: {m}")
        return time.perf_counter() - t0

    step(0)
    torch.cuda.reset_peak_memory_stats()
    seconds = [step(1 + i) for i in range(args.steps)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("timed_steps", card=smi, seconds=seconds, median_s=statistics.median(seconds),
          peak_memory_gib=peak)

    split = split_step(trainer, cams, gt, gen)
    phase("split", card=smi, **split)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.compute_grads(cams[0:1], gt[0:1], generator=gen)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    spans: dict[str, dict] = {}
    for e in events:
        if e.name in SPANS and e.device_type == DeviceType.CPU:
            row = spans.setdefault(e.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0})
            row["calls"] += 1
            row["host_s"] += e.time_range.elapsed_us() / 1e6
            row["device_s"] += e.device_time_total / 1e6
    by_kernel: dict[str, list[float]] = {}
    for e in kernels:
        by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ours = {k: {"launches": len(v), "device_s": sum(v) / 1e6}
            for k, v in by_kernel.items() if k.startswith(("geosplat::", "void geosplat::"))}
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:25]
    top_rows = [{"kernel": name[:120], "launches": len(ts), "device_s": sum(ts) / 1e6,
                 "share_of_busy": sum(ts) / max(busy_us, 1e-9)} for name, ts in top]
    trace = {"card": smi, "cameras": 1, "wall_s": traced_s, "device_busy_s": busy_us / 1e6,
             "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / traced_s),
             "kernel_launches": len(kernels), "spans": spans, "k1_k3": ours,
             "top_kernels": top_rows}
    phase("trace_one_camera", **trace)

    summary = {"card": smi, "config": CONFIG, "median_step_s": statistics.median(seconds),
               "step_s": seconds, "peak_memory_gib": peak, "split": split, "trace": trace}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
