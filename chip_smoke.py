#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geosplatting_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the exit code is not 0):
1. toolchain: torch / CUDA / nvcc versions, the card, and the kernel build
   from csrc/ with ptxas' register / shared-memory / spill report;
2. K3 (prefix sum) against torch.cumsum at [1.4M, 10];
3. K1 / K2 (compositing forward / backward) against their plain versions on
   a seeded 2k-Gaussian scene at 128x128, 16x16 and 16x8 tiles; then the
   main path's render at a small size on the card against the CPU path;
4. the stage-1 slice at full width: GeoSplatter(resolution=96, scale=0.8,
   pairs_budget=1.4M), 8 orbit cameras at 800x800, an analytic-sphere
   ground truth and the SDF sphere init, trained by GeoSplatTrainer for one
   vertex-sampling step at step 0 and three face-sampling steps from step
   200 — every loss finite, no non-finite gradients, pair_fill <= 1, and
   K1 / K2 launched once per camera and K3 at least once per camera on
   every step;
5. the kernels line: each kernel held to its tolerance against its plain
   version at the slice's own inputs, its launches, its CUDA-event time
   there, the plain
   version's time, its least possible time (bound) and a library yardstick.
The last three lines are the card's name and power limit, the kernels JSON
line and the result JSON line. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# FP32 operations per live (pair, pixel), counting an FMA as 2 and expf as 1
# (the inner loops of csrc/rasterize_pairs.cu):
#   K1: offsets 2, sigma 9, exp 1, alpha/keep 4, weight 1, T update 2,
#       accumulation 2 (C + 2)
#   K2: K1's evaluation 16, T rebuild 2, s 2 (C + 2), d_alpha + suffix 6,
#       geometry terms 14, exp 1 + 1, color/depth terms C + 1, and the
#       pair's 7 + C per-pixel terms summed across the tile
def k1_ops_per_pair_px(c: int) -> int:
    return 17 + 2 * (c + 2)


def k2_ops_per_pair_px(c: int) -> int:
    return 40 + 2 * (c + 2) + (c + 1) + (7 + c)


def toolchain(kernels) -> str:
    import torch

    phase("toolchain_python", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib, log = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    report = []
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            report.append({"kernel": fn, "spill_stores": int(m.group(1)),
                           "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and report:
            report[-1].update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    phase("toolchain", nvcc=nvcc, nvidia_smi=smi, build_s=round(build_s, 3),
          library=str(lib.name), ptxas=report)
    if len(report) < 4:
        raise RuntimeError(f"expected 4 compiled kernels in the ptxas report, got {report}")
    return smi


def check_k3(device, gen) -> dict:
    import torch

    from geosplatting_tpu_torch.ops.segment_rows import cumsum_rows, cumsum_rows_plain

    x = torch.randn((1_400_000, 10), generator=gen, device=device)
    got = cumsum_rows(x)
    want = cumsum_rows_plain(x)
    exact = torch.cumsum(x.double(), 0)
    scale = torch.cumsum(x.abs().double(), 0)
    # both sum in f32 in different orders: hold each to the f64 prefix,
    # relative to the running |prefix|
    err_k = float(((got.double() - exact).abs() / (scale + 1e-6)).max())
    err_p = float(((want.double() - exact).abs() / (scale + 1e-6)).max())
    max_abs = float((got - want).abs().max())
    phase("k3_vs_plain", shape=[1_400_000, 10], max_abs_err=max_abs,
          kernel_rel_to_abs_prefix=err_k, plain_rel_to_abs_prefix=err_p, tol=1e-5)
    if not err_k <= 1e-5:
        raise AssertionError(f"K3 error {err_k} > 1e-5 of the running |prefix|")
    return {"max_abs_err": max_abs}


def small_scene(device, gen, num=2000, width=128, height=128):
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras

    means = (torch.rand((num, 3), generator=gen, device=device) * 2 - 1) * 0.8
    quats = torch.nn.functional.normalize(torch.randn((num, 4), generator=gen, device=device), dim=-1)
    scales = torch.exp(torch.rand((num, 3), generator=gen, device=device) * 2.5 - 4.5)
    opac = torch.rand((num,), generator=gen, device=device) * 0.65 + 0.3
    colors = torch.rand((num, 3), generator=gen, device=device)
    cam = Cameras.from_lookat(torch.tensor([2.0, 1.0, 1.5], device=device),
                              torch.zeros(3, device=device), width=width, height=height)
    return means, quats, scales, opac, colors, cam


def check_k1_k2(device, gen) -> dict:
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops.projection import project

    worst = {"k1": 0.0, "k2": 0.0}
    means, quats, scales, opac, colors, cam = small_scene(device, gen)
    proj = project(means, quats, scales, opac, cam.view_matrix, cam.intrinsic_matrix,
                   cam.width, cam.height)
    for tile in ("16", "16x8"):
        grid = rp.tile_grid(cam.width, cam.height, tile)
        bins = rp.bin_pairs(proj, cam.width, cam.height, tile_size=(grid.tsx, grid.tsy),
                            max_pairs=1 << 16)
        pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, colors,
                              proj.depths)
        out, tf, nc = rp.composite_fwd(pairs, bins.seg_start, grid, 3)
        out_p, _, nc_p = rp.composite_fwd_plain(pairs, bins.seg_start, grid, 3)
        g = torch.rand(out.shape, generator=gen, device=device)
        d = rp.composite_bwd(pairs, bins.seg_start, grid, 3, g, tf, nc, pairs.shape[0])
        d_p = rp.composite_bwd_plain(pairs, bins.seg_start, grid, 3, g, tf, nc, pairs.shape[0])
        torch.cuda.synchronize()
        e1 = float((out - out_p).abs().max())
        flips = float((nc != nc_p).float().mean())
        e2 = float((d - d_p).abs().max())
        over2 = float(((d - d_p).abs() > 2e-3 + 2e-3 * d_p.abs()).float().sum())
        phase("k1_k2_vs_plain", tile=tile, pairs=int(bins.total_pairs), k1_max_abs_err=e1,
              contributor_count_flips=flips, k2_max_abs_err=e2, k2_over_tol=over2,
              tol={"k1_atol": 1e-3, "k2_atol": 2e-3, "k2_rtol": 2e-3})
        if not (e1 <= 1e-3 and flips < 0.01 and over2 == 0):
            raise AssertionError(f"K1/K2 disagree with their plain versions ({tile})")
        worst["k1"] = max(worst["k1"], e1)
        worst["k2"] = max(worst["k2"], e2)
    return worst


def sphere_gt(cams):
    """sRGB rgba views of a shaded sphere of radius 0.5 (analytic ray hits)."""
    import torch

    from geosplatting_tpu_torch.graphics import images

    origins, dirs = cams.generate_rays()
    b = (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - 0.25
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0) & (t > 0)
    n = (origins + t[..., None] * dirs) / 0.5
    light = torch.tensor([0.577, 0.577, 0.577], device=n.device)
    shade = torch.clamp((n * light).sum(-1), 0.1, 1.0)
    rgb = torch.where(hit[..., None], shade[..., None] * 0.8, 0.0).expand(*hit.shape, 3)
    a = hit[..., None].float()
    return torch.cat((images.rgb2srgb(rgb) * a, a), -1)


class Recorder:
    """Keeps the arguments of the last call of a kernel wrapper (no launch)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapped(*args):
            self.args = args
            return self.fn(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


SLICE = dict(grid=96, cameras=8, resolution=800, pairs_budget=1_400_000)


def make_slice(device, gen, *, grid, cameras, resolution, pairs_budget, **model_kw):
    """The stage-1 workload of bench.py:136-163: GeoSplatter with the SDF
    sphere init (-0.45), orbit cameras (radius 2, elevation 15 degrees) and
    the analytic-sphere ground truth. Returns (trainer, cameras, gt)."""
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.train.geosplat_trainer import (
        GeoSplatTrainer, GeoSplatTrainerConfig,
    )

    model = GeoSplatter(resolution=grid, scale=0.8, pairs_budget=pairs_budget,
                        generator=gen, device=device, **model_kw)
    with torch.no_grad():
        model.sdf.copy_(torch.linalg.norm(model.grid.base_vertices(device), dim=-1) - 0.45)
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                              num_samples=cameras, width=resolution, height=resolution,
                              device=device)
    trainer = GeoSplatTrainer(GeoSplatTrainerConfig(batch_size=cameras), model)
    return trainer, cams, sphere_gt(cams)


def check_render_card_vs_cpu(device, seed) -> None:
    """The main path's render at a small size on the card (kernels) and on
    the CPU (plain versions) from the same weights and jitter noise."""
    import torch

    small = dict(grid=16, cameras=2, resolution=64, pairs_budget=None,
                 light_resolution=32, triplane_resolution=32)
    gen = torch.Generator().manual_seed(seed)
    trainer, cams, _ = make_slice("cpu", gen, **small)
    model = trainer.model
    mesh, _, _ = model.get_geometry()
    noise = torch.randn((model.num_field_points(mesh), 3), generator=gen)
    with torch.no_grad():
        rgba_cpu, reg_cpu, aux_cpu = model.render(cams, jitter_noise=noise)
        model.to(device)
        rgba, reg, aux = model.render(cams.to(device), jitter_noise=noise.to(device))
    err = float((rgba.cpu() - rgba_cpu).abs().max())
    reg_err = abs(float(reg) - float(reg_cpu)) / abs(float(reg_cpu))
    phase("render_card_vs_cpu", shape=list(rgba.shape), max_abs_err=err, reg_rel_err=reg_err,
          num_gaussians=int(aux["num_gaussians"]), tol={"atol": 1e-3, "reg_rtol": 1e-4})
    if not (bool(torch.isfinite(rgba).all()) and err <= 1e-3 and reg_err <= 1e-4
            and int(aux["num_gaussians"]) == int(aux_cpu["num_gaussians"]) > 0):
        raise AssertionError("the card's render disagrees with the CPU path")


def train_slice(device, seed, kernels) -> tuple[dict, dict]:
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    batch = SLICE["cameras"]
    gen = torch.Generator(device=device).manual_seed(seed)
    trainer, cams, gt = make_slice(device, gen, **SLICE)
    model = trainer.model
    phase("slice_config", **SLICE, max_render_faces=model.max_render_faces,
          parameters=sum(p.numel() for p in model.parameters()))

    totals = {k: 0 for k in kernels.KERNELS}
    # step 0 samples the vertices (warm-up), steps from 200 the faces
    face_seconds, steps = [], [0, 200, 201, 202]
    recorders = [Recorder(rp, "composite_fwd"), Recorder(rp, "composite_bwd"),
                 Recorder(sr, "cumsum_rows")]
    last = {}
    for i, step in enumerate(steps):
        sampling = trainer.sampling_at(step)
        if i == len(steps) - 1:
            for r in recorders:
                r.__enter__()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(cams, gt, float(step), sampling=sampling, generator=gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: kernels.launches[k] for k in kernels.KERNELS}
        metrics = {k: float(v) for k, v in m.items()}
        phase("train_step", step=step, sampling=sampling, seconds=round(seconds, 4),
              launches=counts, **{k: metrics[k] for k in (
                  "loss", "reg", "splat_psnr", "nonfinite_grads", "pair_fill", "face_fill",
                  "num_gaussians")})
        if not all(math.isfinite(metrics[k]) for k in ("loss", "reg")):
            raise AssertionError(f"non-finite loss at step {step}: {metrics}")
        if metrics["nonfinite_grads"] != 0 or not metrics["pair_fill"] <= 1.0:
            raise AssertionError(f"step {step}: {metrics}")
        if not (counts["k1_composite_fwd"] == batch and counts["k2_composite_bwd"] == batch
                and counts["k3_cumsum_rows"] >= batch):
            raise AssertionError(f"step {step}: kernel launches {counts} for {batch} cameras")
        for k in totals:
            totals[k] += counts[k]
        if sampling == "face":
            face_seconds.append(seconds)
        last = metrics
    for r in recorders:
        r.__exit__()
    captured = {"fwd": recorders[0].args, "bwd": recorders[1].args, "k3": recorders[2].args}
    summary = {"launches": totals, "face_step_seconds": face_seconds, "last": last,
               "steps": len(steps)}
    return summary, captured


def kernel_line(captured, slice_summary, errors) -> dict:
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    pairs, seg_start, grid, channels = captured["fwd"]
    (b_pairs, b_seg, b_grid, b_ch, grad_out, t_final, n_contrib, max_pairs) = captured["bwd"]
    (k3_in,) = captured["k3"]
    width = rp.HDR + channels
    tiles, npx = grid.num_tiles, grid.pixels
    live = float(n_contrib.double().sum())           # live (pair, pixel) evaluations
    in_tiles = int(seg_start[-1])                      # pairs inside some tile
    steps = slice_summary["steps"]
    launches = slice_summary["launches"]

    out, _, _ = rp.composite_fwd(pairs, seg_start, grid, channels)
    out_p, _, _ = rp.composite_fwd_plain(pairs, seg_start, grid, channels)
    d = rp.composite_bwd(*captured["bwd"])
    d_p = rp.composite_bwd_plain(*captured["bwd"])
    k3 = sr.cumsum_rows(k3_in)
    torch.cuda.synchronize()
    # the tolerances of check_k1_k2 / check_k3, at the main path's own inputs;
    # K2's per-pair gradients scale with the loss, so its atol is relative to
    # the largest one
    k1_err = float((out - out_p).abs().max())
    d_scale = float(d_p.abs().max())
    k2_over = float(((d - d_p).abs() > 2e-3 * d_scale + 2e-3 * d_p.abs()).float().mean())
    k3_rel = float(((k3.double() - torch.cumsum(k3_in.double(), 0)).abs()
                    / (torch.cumsum(k3_in.abs().double(), 0) + 1e-6)).max())
    phase("kernels_vs_plain_at_slice", k1_max_abs_err=k1_err, k2_share_over_tol=k2_over,
          k2_max_abs_grad=d_scale, k3_rel_to_abs_prefix=k3_rel,
          tol={"k1_atol": 1e-3, "k2_atol": "2e-3 * max|d|", "k2_rtol": 2e-3,
               "k3_rel": 1e-5})
    if not (k1_err <= 1e-3 and k2_over == 0.0 and k3_rel <= 1e-5):
        raise AssertionError("a kernel disagrees with its plain version at the slice's inputs")

    entries = []
    k1_bytes = in_tiles * width * 4 + (tiles + 1) * 8 + tiles * npx * (channels + 4) * 4
    k1_bound, k1_by = bound_ms(k1_bytes, live * k1_ops_per_pair_px(channels))
    entries.append({
        "name": "k1_composite_fwd", "route": "cuda",
        "source": "geosplatting_tpu_torch/csrc/rasterize_pairs.cu",
        "replaces": "geosplatting_tpu/ops/rasterize_pairs.py:483",
        "launches": launches["k1_composite_fwd"],
        "launches_per_step": launches["k1_composite_fwd"] / steps,
        "max_abs_err": k1_err,
        "max_abs_err_small_scene": errors["k1"],
        "ms": cuda_ms(lambda: rp.composite_fwd(pairs, seg_start, grid, channels), 20),
        "plain_ms": cuda_ms(lambda: rp.composite_fwd_plain(pairs, seg_start, grid, channels), 3),
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        "live_pair_pixels": live,
    })
    k2_bytes = (in_tiles * width * 4 + (tiles + 1) * 8 + tiles * npx * (channels + 4) * 4
                + max_pairs * width * 4)
    k2_bound, k2_by = bound_ms(k2_bytes, live * k2_ops_per_pair_px(channels))
    entries.append({
        "name": "k2_composite_bwd", "route": "cuda",
        "source": "geosplatting_tpu_torch/csrc/rasterize_pairs.cu",
        "replaces": "geosplatting_tpu/ops/rasterize_pairs.py:548",
        "launches": launches["k2_composite_bwd"],
        "launches_per_step": launches["k2_composite_bwd"] / steps,
        "max_abs_err": float((d - d_p).abs().max()),
        "max_abs_err_small_scene": errors["k2"],
        "ms": cuda_ms(lambda: rp.composite_bwd(*captured["bwd"]), 20),
        "plain_ms": cuda_ms(lambda: rp.composite_bwd_plain(*captured["bwd"]), 3),
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
        "live_pair_pixels": live,
    })
    m, c = k3_in.shape
    k3_bound, k3_by = bound_ms(2 * m * c * 4, m * c)
    cumsum = cuda_ms(lambda: torch.cumsum(k3_in, 0), 20)
    entries.append({
        "name": "k3_cumsum_rows", "route": "cuda",
        "source": "geosplatting_tpu_torch/csrc/segment_rows.cu",
        "replaces": "geosplatting_tpu/ops/segment_rows.py:31",
        "launches": launches["k3_cumsum_rows"],
        "launches_per_step": launches["k3_cumsum_rows"] / steps,
        "max_abs_err": float((k3 - torch.cumsum(k3_in, 0)).abs().max()),
        "max_abs_err_random_1p4m": errors["k3"],
        "shape": [m, c],
        "ms": cuda_ms(lambda: sr.cumsum_rows(k3_in), 20),
        "plain_ms": cumsum,   # the plain version is torch.cumsum itself
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": cumsum,
    })
    return {"kernels": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from geosplatting_tpu_torch import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = toolchain(_kernels)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    errors = {"k3": check_k3(device, gen)["max_abs_err"], **check_k1_k2(device, gen)}
    check_render_card_vs_cpu(device, args.seed)
    summary, captured = train_slice(device, args.seed, _kernels)
    face = summary["face_step_seconds"]
    phase("slice", launches=summary["launches"], face_step_seconds=face,
          median_face_step_s=sorted(face)[len(face) // 2], card=smi,
          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    line = kernel_line(captured, summary, errors)
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
