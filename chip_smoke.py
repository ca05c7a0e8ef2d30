#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geosplatting_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the exit code is not 0):
1. toolchain: torch / CUDA / nvcc versions, the card, and the kernel build
   from csrc/ with ptxas' register / shared-memory / spill report;
2. K3 (prefix sum) against torch.cumsum at [1.4M, 10];
3. K1 / K2 (compositing forward / backward, two passes each over chunks of
   each tile's pairs) against their plain versions on a seeded 2k-Gaussian
   scene at 128x128, 16x16 and 16x8 tiles and 32-pair chunks; then the main
   path's render at a small size on the card against the CPU path;
4. the stage-1 slice at full width: GeoSplatter(resolution=96, scale=0.8,
   pairs_budget=1.4M), 8 orbit cameras at 800x800, an analytic-sphere
   ground truth and the SDF sphere init, trained by GeoSplatTrainer for one
   vertex-sampling step at step 0 and three face-sampling steps from step
   200 — every loss finite, no non-finite gradients, pair_fill <= 1, and
   each pass of K1 / K2 launched once per camera and K3 at least once per
   camera on every step;
5. the kernels line: each kernel pass held to its tolerance against its
   plain version at the slice's own inputs (and K1 to its own bits on a
   second run), its launches, its CUDA-event time there, the plain
   version's time, its least possible time (bound) for the work these
   inputs need (walked and kept pair-pixels, chunks) and a library
   yardstick.
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


# FP32 operations per (pair, pixel), counting an FMA as 2 and expf as 1
# (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu). Every walked pair-pixel
# pays the evaluation (offsets 2, sigma 9, exp 1, alpha / keep 4); only a
# kept one pays the rest:
#   K1 products: 1 - alpha and the product, 2;
#   K1 compositing: weight 1, T update 2, accumulation 2 (C + 2);
#   K2 suffix: s 2 (C + 2), w 2, sum 2, T update 2;
#   K2 gradients: reciprocal and T rebuild 2, w 1, s 2 (C + 2), d_alpha 4,
#       suffix 2, d_sigma 1, geometry terms 14, d_opacity 1, colour and depth
#       terms C + 1, and the pair's 7 + C terms summed across the tile.
EVAL_OPS = 16


def kept_ops(kernel: str, c: int) -> int:
    return {
        "k1_chunk_products": 2,
        "k1_composite_fwd": 3 + 2 * (c + 2),
        "k2_chunk_suffix": 6 + 2 * (c + 2),
        "k2_composite_bwd": 25 + 2 * (c + 2) + (c + 1) + (7 + c),
    }[kernel]


def pair_pixel_counts(pairs, seg_start, grid, n_contrib) -> dict:
    """What these inputs need of K1 and K2: the walked (pair, pixel)
    evaluations (each pixel's pairs up to its contributor count), the kept
    ones among them (sigma >= 0 and alpha >= 1/255), all (pair, pixel) of
    the pairs in some tile, the tiles holding a pair and the largest tile."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp

    kept = 0
    for t0, t1, idx, live in rp._tile_groups(seg_start, grid.pixels):
        px, py = rp._pixel_centers(grid, t0, t1, pairs.device)
        keep = rp._alphas(pairs[idx], live, px, py)[-1]
        rank = torch.arange(idx.shape[1], device=pairs.device)[None, :, None]
        kept += int((keep & (rank < n_contrib[t0:t1, None, :])).sum())
    counts = seg_start[1:] - seg_start[:-1]
    return {
        "walked_pair_pixels": int(n_contrib.long().sum()),
        "kept_pair_pixels": kept,
        "tile_pair_pixels": int(seg_start[-1]) * grid.pixels,
        "tiles_with_pairs": int((counts > 0).sum()),
        "max_pairs_per_tile": int(counts.max()),
    }


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
    libs, log = kernels.build()
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
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and report:
            report[-1].update(registers=int(m.group(1)), smem_bytes=int(m.group(2) or 0))
    # the compositing kernels are instantiated for C = 1..16: show C = 3 (the
    # main path's) and the largest register count and spills of any C
    shown = [r for r in report if "ILi3E" in r["kernel"] or "ILi" not in r["kernel"]]
    phase("toolchain", nvcc=nvcc, nvidia_smi=smi, build_s=round(build_s, 3),
          libraries=[lib.name for lib in libs], compiled_kernels=len(report),
          max_registers=max((r.get("registers", 0) for r in report), default=0),
          spill_bytes=sum(r["spill_stores"] + r["spill_loads"] for r in report),
          ptxas_c3=shown)
    if len(report) < 4 * 16 + 1 + 3:
        raise RuntimeError(f"expected 68 compiled kernels in the ptxas report, got {report}")
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


def check_passes(pairs, seg_start, grid, channels, chunks, grad_out) -> dict:
    """Each pass of K1 and K2 on these inputs against its plain version.
    Raises where one disagrees; returns the errors and the kernels' outputs.
    Tolerances: K1's products 2e-5 * |x| + 1e-7 (at most 256 factors, each
    rounding by up to 2^-24, multiplied in another order); K1's
    image atol 1e-3 and under 1 % of contributor counts flipped (the kernel
    starts each chunk from a product of chunk products, so a pixel at the
    T = 1e-4 cutoff may flip, tests/test_rasterize_pallas.py:53); K2's suffix
    sums and per-pair gradients, fed the kernel's saved state so the rank
    gates agree, 2e-3 * max|x| + 2e-3 * |x| (they scale with the loss)."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp

    prod = rp.chunk_products(pairs, seg_start, grid, channels, chunks)
    out, tf, nc = rp.composite_fwd(pairs, seg_start, grid, channels, chunks, prod)
    suffix = rp.chunk_suffix(pairs, seg_start, grid, channels, chunks, prod, grad_out, nc)
    d = rp.composite_bwd(pairs, seg_start, grid, channels, grad_out, tf, nc, pairs.shape[0],
                         chunks, prod, suffix)
    prod_p = rp.chunk_products_plain(pairs, seg_start, grid, chunks)
    out_p, _, nc_p = rp.composite_fwd_plain(pairs, seg_start, grid, channels)
    suffix_p = rp.chunk_suffix_plain(pairs, seg_start, grid, channels, chunks, grad_out, nc)
    d_p = rp.composite_bwd_plain(pairs, seg_start, grid, channels, grad_out, tf, nc,
                                 pairs.shape[0])
    torch.cuda.synchronize()

    def over(x, x_p):
        return float(((x - x_p).abs() > 2e-3 * float(x_p.abs().max()) + 2e-3 * x_p.abs())
                     .float().mean())

    errors = {
        "k1_chunk_products": float((prod - prod_p).abs().max()),
        "k1_composite_fwd": float((out - out_p).abs().max()),
        "k2_chunk_suffix": float((suffix - suffix_p).abs().max()),
        "k2_composite_bwd": float((d - d_p).abs().max()),
    }
    checks = {
        "contributor_count_flips": float((nc != nc_p).float().mean()),
        "k2_suffix_share_over_tol": over(suffix, suffix_p),
        "k2_grad_share_over_tol": over(d, d_p),
        "k2_max_abs_grad": float(d_p.abs().max()),
    }
    checks["k1_products_share_over_tol"] = float(
        ((prod - prod_p).abs() > 2e-5 * prod_p.abs() + 1e-7).float().mean())
    ok = (checks["k1_products_share_over_tol"] == 0 and errors["k1_composite_fwd"] <= 1e-3
          and checks["contributor_count_flips"] < 0.01
          and checks["k2_suffix_share_over_tol"] == 0 and checks["k2_grad_share_over_tol"] == 0)
    return {"errors": errors, "checks": checks, "ok": ok, "out": (out, tf, nc, prod, suffix)}


def check_k1_k2(device, gen) -> dict:
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops.projection import project

    worst = {}
    means, quats, scales, opac, colors, cam = small_scene(device, gen)
    proj = project(means, quats, scales, opac, cam.view_matrix, cam.intrinsic_matrix,
                   cam.width, cam.height)
    for tile, kc in (("16", rp.CHUNK_PAIRS), ("16x8", rp.CHUNK_PAIRS), ("16", 32)):
        grid = rp.tile_grid(cam.width, cam.height, tile)
        bins = rp.bin_pairs(proj, cam.width, cam.height, tile_size=(grid.tsx, grid.tsy),
                            max_pairs=1 << 16)
        pairs = rp.pack_pairs(bins, proj.means2d, proj.conics, proj.opacities, colors,
                              proj.depths)
        chunks = rp.chunk_list(bins.seg_start, pairs.shape[0], kc)
        g = torch.rand((grid.num_tiles, 5, grid.pixels), generator=gen, device=device)
        res = check_passes(pairs, bins.seg_start, grid, 3, chunks, g)
        phase("k1_k2_vs_plain", tile=tile, kc=kc, pairs=int(bins.total_pairs),
              chunks=int(chunks.tile_chunk_start[-1]), max_abs_err=res["errors"],
              **res["checks"])
        if not res["ok"]:
            raise AssertionError(f"K1/K2 disagree with their plain versions ({tile}, kc={kc})")
        for k, v in res["errors"].items():
            worst[k] = max(worst.get(k, 0.0), v)
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
    recorders = [Recorder(rp, "composite_bwd"), Recorder(sr, "cumsum_rows")]
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
        if not (all(counts[k] == batch for k in kernels.KERNELS[:4])
                and counts["k3_cumsum_rows"] >= batch):
            raise AssertionError(f"step {step}: kernel launches {counts} for {batch} cameras")
        for k in totals:
            totals[k] += counts[k]
        if sampling == "face":
            face_seconds.append(seconds)
        last = metrics
    for r in recorders:
        r.__exit__()
    captured = {"bwd": recorders[0].args, "k3": recorders[1].args}
    summary = {"launches": totals, "face_step_seconds": face_seconds, "last": last,
               "steps": len(steps)}
    return summary, captured


def kernel_line(captured, slice_summary, errors) -> dict:
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    (pairs, seg_start, grid, channels, grad_out, _, _, max_pairs, chunks, _, _) = captured["bwd"]
    (k3_in,) = captured["k3"]
    tiles, npx = grid.num_tiles, grid.pixels
    steps = slice_summary["steps"]
    launches = slice_summary["launches"]

    res = check_passes(pairs, seg_start, grid, channels, chunks, grad_out)
    out, t_final, n_contrib, prod, suffix = res["out"]
    # K1 sums no floats atomically: a second run gives the same bits
    again = rp.composite_fwd(pairs, seg_start, grid, channels, chunks,
                             rp.chunk_products(pairs, seg_start, grid, channels, chunks))
    bitwise = all(torch.equal(a, b) for a, b in zip((out, t_final, n_contrib), again))
    k3 = sr.cumsum_rows(k3_in)
    torch.cuda.synchronize()
    k3_rel = float(((k3.double() - torch.cumsum(k3_in.double(), 0)).abs()
                    / (torch.cumsum(k3_in.abs().double(), 0) + 1e-6)).max())
    counts = pair_pixel_counts(pairs, seg_start, grid, n_contrib)
    n_chunks = int(chunks.tile_chunk_start[-1])
    counts.update(chunks=n_chunks, chunk_slots=int(chunks.chunk_tile.shape[0]), kc=chunks.kc)
    phase("kernels_vs_plain_at_slice", max_abs_err=res["errors"], **res["checks"],
          k1_bitwise_repeatable=bitwise, k3_rel_to_abs_prefix=k3_rel, **counts,
          tol={"k1_products": "2e-5 * |x| + 1e-7", "k1_atol": 1e-3, "count_flips": 0.01,
               "k2_atol": "2e-3 * max|x|", "k2_rtol": 2e-3, "k3_rel": 1e-5})
    if not (res["ok"] and bitwise and k3_rel <= 1e-5):
        raise AssertionError("a kernel disagrees with its plain version at the slice's inputs")

    # bytes each pass must move: inputs read once, outputs written once
    f = 4
    pair_bytes = int(seg_start[-1]) * rp.row_stride(channels) * f
    list_bytes = (tiles + 1) * 8 + (tiles + 1) * 4 + chunks.chunk_tile.shape[0] * 4
    per_chunk = n_chunks * npx * f          # prod or suffix of the real chunks
    per_tile = tiles * npx * f              # t_final, n_contrib, one row of out or grad_out
    passes = {
        "k1_chunk_products": (
            lambda: rp.chunk_products(pairs, seg_start, grid, channels, chunks),
            lambda: rp.chunk_products_plain(pairs, seg_start, grid, chunks),
            pair_bytes + list_bytes + per_chunk, counts["tile_pair_pixels"],
            "geosplatting_tpu/ops/rasterize_pairs.py:483"),
        "k1_composite_fwd": (
            lambda: rp.composite_fwd(pairs, seg_start, grid, channels, chunks, prod),
            lambda: rp.composite_fwd_plain(pairs, seg_start, grid, channels),
            pair_bytes + list_bytes + per_chunk + per_tile * (channels + 4),
            counts["walked_pair_pixels"], "geosplatting_tpu/ops/rasterize_pairs.py:483"),
        "k2_chunk_suffix": (
            lambda: rp.chunk_suffix(pairs, seg_start, grid, channels, chunks, prod, grad_out,
                                    n_contrib),
            lambda: rp.chunk_suffix_plain(pairs, seg_start, grid, channels, chunks, grad_out,
                                          n_contrib),
            pair_bytes + list_bytes + 2 * per_chunk + per_tile * (channels + 3),
            counts["walked_pair_pixels"], "geosplatting_tpu/ops/rasterize_pairs.py:548"),
        "k2_composite_bwd": (
            lambda: rp.composite_bwd(pairs, seg_start, grid, channels, grad_out, t_final,
                                     n_contrib, max_pairs, chunks, prod, suffix),
            lambda: rp.composite_bwd_plain(pairs, seg_start, grid, channels, grad_out, t_final,
                                           n_contrib, max_pairs),
            pair_bytes + list_bytes + 2 * per_chunk + per_tile * (channels + 4)
            + max_pairs * (rp.HDR + channels) * f,
            counts["walked_pair_pixels"], "geosplatting_tpu/ops/rasterize_pairs.py:548"),
    }
    entries = []
    for name, (kernel, plain, nbytes, evaluated, replaces) in passes.items():
        ops = evaluated * EVAL_OPS + counts["kept_pair_pixels"] * kept_ops(name, channels)
        bound, by = bound_ms(nbytes, ops)
        src = "rasterize_fwd.cu" if name.startswith("k1") else "rasterize_bwd.cu"
        entries.append({
            "name": name, "route": "cuda", "source": f"geosplatting_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "launches_per_step": launches[name] / steps,
            "max_abs_err": res["errors"][name],
            "max_abs_err_small_scene": errors[name],
            "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bytes": nbytes, "ops": ops, **counts,
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
