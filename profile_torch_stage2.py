#!/usr/bin/env python3
"""Where one stage-2 train step of the PyTorch port spends its time, on one GPU.

    [BATCHED_BINNING=1] python3 profile_torch_stage2.py [--steps 2] [--seed 0] [--out summary.json]

Builds stage 2 at the s4r presets' widths from a stage-1 export of
chip_smoke.make_slice's GeoSplatter (grid 96, scene scale 0.8, the SDF
sphere init, random weights from --seed): GeoSplatterMC with pairs budget
1.6M, 2^17 render faces, 8 x 8 Monte-Carlo sample steps, 24-step SDF
shadows and denoising; 8 orbit cameras at 800x800 and the analytic-sphere
ground truth; GeoSplatMCTrainer. It runs one step to warm up, then prints,
one JSON line each:
1. the timed steps: host clock around ``--steps`` synchronised steps, and
   the peak device memory;
2. the split: one more step with every piece synchronised and timed on the
   host clock (the sampling, the sphere trace, the Monte-Carlo loop forward
   and its recomputation in the backward, the denoiser, the rasterizer's
   forward, geometry and Gaussians, the rest of the forward and of the
   backward, the update); the synchronisation removes what overlap there
   was, so the split step is slower than a timed one;
3. the trace: ``torch.profiler`` over one camera's forward and backward:
   wall time, the device's busy time and idle share, the device time under
   each span of the port, the kernels K1-K3, and the 25 kernels with the
   most device time.
The last line is the summary, which ``--out`` also writes to a file.
Without a CUDA device it exits non-zero. ``BATCHED_BINNING=1`` builds the
model with ``batched_binning`` (the trainer renders a camera at a time, so
each binning pass holds one camera).
"""
from __future__ import annotations

import argparse
import os
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import STAGE2, make_slice, phase

SPANS = ("trainer.forward", "trainer.backward", "trainer.apply_grads", "geosplat.geometry",
         "geosplat.gaussians", "geosplat.denoise", "envshade.sample", "envshade.visibility",
         "envshade.mc_step", "rasterize.bin_pairs", "rasterize.composite")


class Split:
    """Synchronised host-clock timers wrapped around attributes of modules
    and classes; nested timers each count their own total."""

    def __init__(self):
        self.rows: dict[str, dict] = {}
        self.patched = []
        self.in_forward = False

    def add(self, label: str, seconds: float) -> None:
        row = self.rows.setdefault(label, {"calls": 0, "seconds": 0.0})
        row["calls"] += 1
        row["seconds"] += seconds

    def wrap(self, owner, name: str, label) -> None:
        import torch

        fn = getattr(owner, name)

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                # also when the checkpoint's recomputation stops the call
                # early (by raising) once it has what the backward needs
                torch.cuda.synchronize()
                self.add(label() if callable(label) else label, time.perf_counter() - t0)

        self.patched.append((owner, name, fn))
        setattr(owner, name, wrapped)

    def restore(self) -> None:
        for owner, name, fn in reversed(self.patched):
            setattr(owner, name, fn)
        self.patched.clear()


def build(device, seed: int):
    """(trainer, cameras, ground truth) of stage 2 at the s4r widths."""
    import torch

    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC, export_stage1
    from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
        GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    stage1, cams, gt = make_slice(device, gen, grid=STAGE2["grid"], cameras=STAGE2["cameras"],
                                  resolution=800, pairs_budget=STAGE2["pairs_budget"])
    export = export_stage1(stage1.model)
    planes = export["ks_enc"]["planes"].shape
    model = GeoSplatterMC(
        resolution=STAGE2["grid"], scale=STAGE2["scene_scale"],
        pairs_budget=STAGE2["pairs_budget"], max_render_faces=STAGE2["max_render_faces"],
        num_samples_x=STAGE2["num_samples_x"], shadow_steps=STAGE2["shadow_steps"],
        denoise=STAGE2["denoise"], triplane_resolution=planes[1],
        triplane_components=planes[-1], generator=gen, device=device,
        batched_binning=os.environ.get("BATCHED_BINNING", "0") == "1",
    )
    model.init_from_stage1(export)
    del stage1, export
    return GeoSplatMCTrainer(GeoSplatMCTrainerConfig(batch_size=STAGE2["cameras"]), model), \
        cams, gt, gen


def split_step(trainer, cams, gt, gen, step: float) -> dict:
    import torch

    from geosplatting_tpu_torch.models import geosplat_mc
    from geosplatting_tpu_torch.ops import envshade
    from geosplatting_tpu_torch.train.geosplat_mc_trainer import GeoSplatMCTrainer

    sp = Split()
    make_vis = geosplat_mc.make_sdf_visibility

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

    fwd = GeoSplatMCTrainer._local_loss

    def forward(self, *args, **kw):
        sp.in_forward = True
        try:
            return fwd(self, *args, **kw)
        finally:
            sp.in_forward = False

    sp.patched.append((GeoSplatMCTrainer, "_local_loss", fwd))
    GeoSplatMCTrainer._local_loss = forward
    sp.patched.append((geosplat_mc, "make_sdf_visibility", make_vis))
    geosplat_mc.make_sdf_visibility = timed_visibility
    sp.wrap(GeoSplatMCTrainer, "_local_loss", "forward")
    sp.wrap(torch.Tensor, "backward", "backward")
    sp.wrap(GeoSplatMCTrainer, "_apply_grads", "apply_grads")
    sp.wrap(geosplat_mc.GeoSplatterMC, "get_geometry", "geometry")
    sp.wrap(geosplat_mc, "get_gaussians_from_face", "gaussians")
    sp.wrap(envshade, "_draw_samples", "sampling_and_trace")
    sp.wrap(envshade, "_mc_step",
            lambda: "mc_loop_forward" if sp.in_forward else "mc_loop_recompute")
    sp.wrap(geosplat_mc, "bilateral_denoise", "denoise")
    sp.wrap(geosplat_mc, "rasterize", "rasterize_forward")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(cams, gt, step, generator=gen)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        sp.restore()
    r = {k: v["seconds"] for k, v in sp.rows.items()}
    sampling = r["sampling_and_trace"] - r["sphere_trace"]
    inner = ("geometry", "gaussians", "sampling_and_trace", "mc_loop_forward", "denoise",
             "rasterize_forward")
    return {
        "split_step_s": total,
        "sampling_s": sampling, "sphere_trace_s": r["sphere_trace"],
        "mc_loop_forward_s": r["mc_loop_forward"],
        "mc_loop_recompute_s": r.get("mc_loop_recompute", 0.0),
        "denoise_s": r["denoise"], "rasterize_forward_s": r["rasterize_forward"],
        "geometry_s": r["geometry"], "gaussians_s": r["gaussians"],
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
        print("profile_torch_stage2: no CUDA device; this script runs only on a GPU",
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
        m = trainer.train_step(cams, gt, float(i), generator=gen)
        torch.cuda.synchronize()
        if int(m["nonfinite_grads"]) != 0 or not float(m["pair_fill"]) <= 1.0:
            raise AssertionError(f"step {i}: {m}")
        return time.perf_counter() - t0

    step(60)
    torch.cuda.reset_peak_memory_stats()
    seconds = [step(61 + i) for i in range(args.steps)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("timed_steps", card=smi, seconds=seconds, median_s=statistics.median(seconds),
          peak_memory_gib=peak)

    split = split_step(trainer, cams, gt, gen, 61.0 + args.steps)
    phase("split", card=smi, **split)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.compute_grads(cams[0:1], gt[0:1], 62.0 + args.steps, generator=gen)
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
            for k, v in by_kernel.items() if any(t in k for t in ("k1_", "k2_", "k3_"))}
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:25]
    top_rows = [{"kernel": name[:120], "launches": len(ts), "device_s": sum(ts) / 1e6,
                 "share_of_busy": sum(ts) / max(busy_us, 1e-9)} for name, ts in top]
    trace = {"card": smi, "cameras": 1, "wall_s": traced_s, "device_busy_s": busy_us / 1e6,
             "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / traced_s),
             "kernel_launches": len(kernels), "spans": spans, "k1_k3": ours,
             "top_kernels": top_rows}
    phase("trace_one_camera", **trace)

    summary = {"card": smi, "config": STAGE2, "batched_binning": trainer.model.batched_binning,
               "median_step_s": statistics.median(seconds),
               "step_s": seconds, "peak_memory_gib": peak, "split": split, "trace": trace}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
