#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geosplatting_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the exit code is not 0):
1. toolchain: torch / CUDA / nvcc versions, the card, and the kernel build
   from csrc/ with ptxas' register / shared-memory / spill report;
2. K3 (prefix sum) against torch.cumsum at [1.4M, 10], and K4 (the SDF
   sphere trace) against its plain version at the benchmark cells' trace
   (grid 96, scale 0.8, 2^23 rays, 24 steps), and K5 (the Monte-Carlo
   shading loop, forward and backward) against the plain loop at stage 2's
   and stage 3's shapes, with both versions' times;
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
   plain version at the slice's own inputs (and K1 and K3 to their own bits
   on a second run), its launches, its CUDA-event time there, the plain
   version's time (CUDA events around the second of the two calls that
   check it: the plain versions read their tile counts on the host), its
   least possible time (bound) for the work these inputs need (walked and
   kept pair-pixels, chunks) and a library yardstick; K3's row also gives
   PyTorch's inner-dimension scan of the transposed copy as a second
   yardstick;
6. product: the stage-1 product path as a user runs it. A Blender-layout
   scene of the analytic sphere (800x800 PNGs, 16 train, 2 val, 2 test
   views) is written to a temporary directory, and GeoSplatTrainTask runs
   on it at the slice's width (grid 96, 8 cameras a batch, pairs budget
   1.4M, light resolution 512, the SDF started as the slice's sphere): 4
   steps with a checkpoint at 2 and at 4 and an exact-quality validation
   and the export at 4, then a resume to 6 steps, then the export read back
   and held key by key against the last checkpoint's parameters. It prints
   the validation PSNR, the seconds per step, the validation render's time,
   the export's keys and shapes, and the kernels' launches in this phase.
7. stage2: GeoSplatMCTrainTask loads the product phase's run directory and
   trains on the same scene at the s4r presets' widths (grid 96, scene
   scale 0.8, 8 cameras a batch, pairs budget 1.6M, 2^17 render faces,
   8 x 8 Monte-Carlo sample steps with 24-step SDF shadows, denoising, a
   256 x 512 lat-long light): 1 step with a checkpoint, validation and the
   export (no resume here: phase 6 resumes the shared loop), the
   export read back and held against the step-1 checkpoint key by key and
   against its gaussian_mask.
   Every step's loss and PSNR finite, no non-finite gradient, pair and face
   fill <= 1. It prints the per-step metrics and seconds, the validation's
   seconds and PSNR, the live Gaussians, the peak device memory and the
   kernels' launches in this phase; then every kernel pass is held against
   its plain version again at the inputs of stage 2's last camera, and its
   row of the kernels line gains a "stage2" entry measured there.
8. chain: the four commands of eval.sh through the tasks their CLIs build,
   on a Syn4Relight-layout scene written to a temporary directory
   (write_s4r_scene: a Lambertian sphere under constant environments, so
   every frame is a closed form; 800x800, 16 HDR train frames with masks, 2
   test views with albedo, roughness and frames relit under two
   environments): stage 1 (the s4r-twosphere preset, 2 steps, the SDF
   started as a sphere), stage 2 (its preset, --load that run, 1 step),
   stage 3 at the full width of its s4r-twosphere preset (grid 96, scene
   scale 1.0, 8 cameras a batch at 800x800, pairs budget 1.6M, 8 x 8 sample
   steps, 24-step shadows, mesh tile capacity 1024): 1 step with a
   checkpoint and a validation, the export held key by key against the
   step-1 checkpoint (no resume here: phase 6 resumes the shared
   loop); then reliteval on that run. Gates
   on every stage-3 step: loss, reg and PSNR finite, no non-finite
   gradient, the pair fill and the mesh raster's tile and pair fills <= 1;
   the export's kd and latlng_hue inside float32 [0.01, 0.99]; every number
   of eval.json finite. It prints the per-step seconds, the peak memory, the
   eval metrics (with the closed-form sRGB of the relit frames beside them)
   and the kernels' launches; then every kernel pass is held against its
   plain version at the inputs of stage 3's last G-buffer camera (C = 14),
   and its row of the kernels line gains a "stage3" entry measured there.
9. gsplat: vanilla 3DGS. (a) bench.py's second workload (bench.py:80-122)
   at its widths: Splats.random(50,000, SH degree 0, random_scale 0.8) with
   opacity logits 1.0, GSplatter(sh_degree=0, background black, 32 pairs a
   Gaussian), 8 orbit cameras at radius 2.5 and elevation 15 degrees,
   800x800, the horizontal-gradient ground truth, GSplatTrainer with batch 8
   and densification off: 4 warm-up and 10 timed steps (median s/step and
   it/s, the pairs of each camera, pair_fill, the peak memory, and one more
   step traced by torch.profiler for the device's idle share); every loss
   finite, no non-finite gradient, pair_fill <= 1, K1, K2 and K3 launched
   once per camera on every step. (b) the same scene at SH degree 3 with
   max_sh_degree 3 for 4 steps, then after_update at an opacity-reset step
   and two densify steps (the Gaussian counts, param_map, the kept rows and
   Adam moments, zero moments in the new slots, a finite next step). (c)
   GSplatTrainTask at the blender preset's widths (65,536 Gaussians, SH 3,
   batch 1, 48 pairs a Gaussian) on the product phase's scene: 4 steps, a
   checkpoint, validation and the export, a resume to 6, the export held
   against the last checkpoint key by key. Then every kernel pass is held
   against its plain version at the inputs of (a)'s last camera, and its row
   of the kernels line gains a "gsplat" entry measured there.
10. prior: the mesh-prior variant. (a) The defining scale of
   scripts/prior_scale_demo.py:96-124: GeoSplatterPrior on a 300 x 280 UV
   sphere of radius 0.5 (168,000 faces, 1,008,000 Gaussians) with the
   shared field (occ head), scale 1.0, 4 x 4 sample steps, shadows at 0.95
   through the 64^3 occupancy grid, denoising, pairs budget 2.5M; 4 orbit
   cameras at radius 2 and elevation 20 degrees at 800x800, the analytic
   sphere as ground truth; GeoSplatPriorTrainer at batch 2 for 1 warm-up
   and 2 timed steps, uninstrumented (median s/step, pair_fill, the peak
   memory), then one instrumented step (pairs of each camera, the
   visibility build and march synchronised and their share of that step,
   the kernels' inputs) and one traced step (the device's busy time and
   idle share), the live Gaussians, that deform moved; every step's loss
   and reg finite, no non-finite gradient, pair_fill <= 1, K1, K2 and K3
   launched once per camera. (b) The same with the hash-grid GaussianField
   (the occ encoder of OCC_ENC): 1 timed step and the instrumented one,
   the same gates and numbers.
   (c) GeoSplatPriorTrainTask at the object preset's widths (batch 8, 8 x 8
   sample steps, scene scale 1.05) on the product phase's scene, its prior
   a 120 x 112 UV sphere (26,880 faces) written as binary PLY: 1 step with
   a checkpoint, validation and the export (no resume), the
   export held key by key against the step-1 checkpoint (sdf and
   mc_face_mask None).
   Then every kernel pass is held against its plain version at the inputs
   of (a)'s last camera, and its row of the kernels line gains a "prior"
   entry measured there.
11. gsplat2d: GSplatter's 2dgs mode and the depth render modes. (a)
   bench.py's 3DGS scene of phase 9 in 2dgs mode (32 pairs a Gaussian, tile
   capacity 2560), GSplatTrainer with both regularisers at their JAX
   weights: 1 warm-up and 2 timed steps, uninstrumented (median s/step,
   peak memory), one instrumented step (the compositing's forward and the
   backward synchronised, their shares) and one traced step (busy time,
   idle share, leading device operations); every step's loss, normal loss
   and distortion finite, no non-finite gradient, pair_fill and tile_fill
   <= 1; the pairs and fullest tile of each camera. (b) render_depth in
   both modes on that scene: finite, and where alpha > 0.5 inside the
   camera's depth range (classic: its Gaussians' centres; 2dgs: its near
   and far planes); one classic ED render differentiated (the covered
   pixels' weighted depth), K1-K3 launched, K2's gradient with a non-zero
   depth row. (c) GSplatTrainTask at the blender-2dgs preset on the product
   phase's scene: 2 steps with a checkpoint, validation and the export, a
   resume to 3, the export held against the step-3 checkpoint key by key,
   written as a splat PLY and read back. (d) One 2DGS step at a small size
   on the card against the CPU. Then every kernel pass is held against its
   plain version at (b)'s inputs, and its row of the kernels line gains a
   "depth" entry measured there.
12. captures: the capture layouts, each scene written to a temporary
   directory at its real layout's image size. (a) A COLMAP scene
   (sparse/0/*.bin, one PINHOLE camera at 1297x840, mip-NeRF 360 garden's
   images_4 size: 24 orbit views of the analytic sphere, 10k points):
   GeoSplatPriorTrainTask at the unbounded preset (batch 4, scene scale
   2.0) through the CLI's task, its prior phase 10 (a)'s 300 x 280 UV
   sphere as PLY (1,008,000 Gaussians): 1 step with a checkpoint,
   validation and the export (no resume), the export held
   against the step-1 checkpoint; median s/step, peak memory, pairs and the fullest
   tile of each camera. (b) A Stanford-ORB scene (blender_LDR/sphere, 16 +
   2 views of 2048x2048 PNGs with masks, the ground-truth mesh): 2
   GeoSplatTrainTask steps at the product phase's widths at the parser's
   1024x1024 and a validation. (c) A masked-IDR (DTU) scene (1600x1200,
   cameras_large.npz, the principal point off the centre) read at 0.4: the
   same, and each validation render's silhouette centroid within 1 px of
   the sphere's centre projected with the camera's own fx, fy, cx, cy.
   Gates on every step of (a)-(c): loss finite, no non-finite gradient,
   pair_fill <= 1, K1, K2 and K3 launched once per camera. (d)
   MeshPBRDataparser at 800 on a UV sphere with vertex colours under an
   HDR sky written as .hdr (8 / 2 / 2 views): seconds a view, the mesh
   raster's fills <= 1 on every view, every image finite with some alpha,
   one view on the card against the CPU. (e) dpsr_solve and psr_to_mesh at
   128^3 from 100k oriented points of a sphere, tsdf_fusion at 128^3 of
   (d)'s depth renders, each mesh's chamfer distance to its sphere within a
   stated bound, dpsr_solve card vs CPU at 64^3. Then every kernel pass is
   held against its plain version at (a)'s last camera (edge tiles 1 px
   wide and 8 px tall), and its row of the kernels line gains a "captures"
   entry measured there.
13. quality: (a) bench/quality_chain.run_quality_chain at the JAX package's
   tiny shape (tests/test_quality.py:45-50: 32x32, grid 10, 10 train and 2
   test views of the analytic two-sphere PBR scene, batch 2, 40 / 12 / 8
   steps, 6 x 6 ground-truth and 2 x 2 training sample steps, light 32, the
   material triplane at its 512 texels): every trainer step's loss and PSNR
   finite, no non-finite gradient, every fill it reports <= 1 (pair_fill,
   face_fill, stage 3's mesh_tile_fill and mesh_pair_fill), K1, K2 and K3
   launched once per camera and rasterization on every step of every stage
   (stage 3 rasterizes a camera twice: its G-buffer and the kd map of its
   edge-aware regulariser; the normal map's weight is 0); NVS, relight and
   albedo PSNR, roughness MSE and stage-1 train PSNR past the JAX package's
   floors (tests/test_quality.py:52-58); it prints the result with each
   stage's seconds a step and peak memory. (b) The product phase's
   GeoSplatTrainTask for 2 steps with turntable="+z" and vis_export_every
   1: a non-empty 800x800 frame in dump/vis/ at every step of the schedule,
   a non-empty HTML viewer with Gaussians in vis_html/ at every step.
   Then every kernel pass is held against its plain version at (a)'s
   inputs of stage 2's last camera (C = 3) and of stage 3's last G-buffer
   camera (C = 14), and its row of the kernels line gains "quality_stage2"
   and "quality" entries measured there.
14. batched: the camera-batched rasterizer (every camera projected, then
   binned in one pass: one sort of all B x max_pairs keys) against the
   per-camera path, with the JAX package's own tolerances between its two
   paths; each comparison runs under PyTorch's deterministic algorithms
   (``deterministic``: the default index_add_ sums with float atomics, and
   two runs of one path differ by as much as the tolerances). (a) The slice (phase 4's widths) built twice from the seed, once
   with batched_binning: one forward and backward from the same state,
   jitter draw and background at step 200 on each path, their per-camera
   pair lists (sorted_gid, seg_start, total_pairs) equal exactly, RGBA
   within 1e-5 / 1e-5, loss and flattened gradients within 2e-4 / 2e-3;
   then 2 timed batched steps (median s/step beside phase 4's, peak memory,
   K1-K3 launched once per camera per step, the same gates as phase 4) and
   the device memory the binning alone takes, batched and for one camera.
   (b) Phase 9 (a)'s 3DGS workload with camera_batching="vmap" against
   "map": the images, one step's xys_grad_norm and vis_counts, then 4 + 10
   timed vmap steps. (c) One render and backward of 2 cameras at 800x800
   per camera and batched: stage 2 at phase 7's widths from the product
   run's stage-1 export (RGBA 5e-4 / 1e-3, gradients 1e-3 / 5e-3) and stage
   3 at the chain's widths from its stage-2 run (gradients 1e-2 / 5e-3),
   pair lists equal; stage 2 once more with tone_type="aces", finite and in
   [0, 1]. (d) Every kernel pass held against its plain version at (a)'s
   last camera, and its row of the kernels line gains a "batched" entry.
   (e) On the card against the CPU from the same inputs: antialias at
   800x800 on a fixed mesh, phase 10 (c)'s 120 x 112 UV sphere (the value
   in float32 within 2e-4, about three ulps of an 800-px coordinate; the
   vertex gradient within 1e-3 of its largest entry in float64: in float32
   a pixel pair whose edge crosses exactly at its midpoint on one device
   and an ulp off it on the other passes its gradient on one device only,
   and that error is reported beside it),
   images.resize with every method jax.image.resize takes at 800 -> 512
   and 512 -> 800 (within 1e-5, "nearest" equal), and env_shade with
   bsdf="diffuse" and "white"
   (the card-vs-CPU rule of tests/test_torch_kernels_gpu.py, no specular).
   (f) Phase 11 (a)'s 2DGS scene with camera_batching="vmap" (every camera
   binned in one sort) against "map": each camera's dense tile table equal
   exactly, the images, the regularisers' maps, one step's loss, gradients
   and densification statistics within (b)'s tolerances, then 1 warm-up
   and 2 timed steps of each path, alternating.
15. scripts_dp: the root entry scripts and multi-GPU training. (a)
   scripts/make_synthetic_scene writes the two-sphere quality scene in the
   Syn4Relight layout at 160^2 (the nearest size to the quality benchmark's
   reduced 128^2 that divides the layout's 800^2; 8 train, 2 test views, 4
   x 4 ground-truth samples), then scripts/run_pipeline trains stages 1 ->
   2 -> 3 on it at the reduced shape's grid 48, batch 4 and 4 x 4 training
   samples (light 128; 2 / 1 / 1 steps) and runs reliteval: every stage's loss and PSNR finite, no
   non-finite gradient, every fill <= 1, every eval number finite, K1-K3
   launched, the three exports and the checkpoint written. (b)
   scripts/premask on that scene with the two spheres as a 48 x 64 UV-sphere
   mesh each at 160^2 (tile capacity 8192): the layout read back through
   RFMaskedRealDataparser, every view's mask within an IoU of 0.97 of the
   scene's alpha, the fullest tile against the capacity. (c) Two ranks in
   fresh processes (spawn) on a gloo group sharing the one card (NCCL
   refuses two ranks on one device), under deterministic algorithms:
   train_step_dp of the slice (4 cameras a rank), of stage 2 at the stage2
   phase's widths from the product run and of stage 3 at the chain's from
   its stage-2 run (2 cameras of 800x800, 1 a rank), and of bench.py's 3DGS
   workload (4 cameras a rank), each against this process's train_step on
   the whole batch from the same seed and generator state: the loss within
   rtol 1e-4, the gradients within the JAX package's DP bounds (rtol 1e-3,
   atol 2e-5 for stage 1 and 3DGS with its densification statistics; rtol
   2e-3, atol 2e-5 for stages 2 and 3), every parameter bit-equal across the
   ranks after a second step; each rank's step seconds, the bytes the
   gradients' all-reduce moved and its seconds (two processes on one card:
   correctness and collective overhead, not scaling). (d)
   rasterize_tile_sharded at bench.py's 3DGS scene (50k Gaussians, 800x800)
   and rasterize_gs_sharded at the prior's scale (1,008,000 Gaussians on its
   sphere, 800x800) on the two ranks, against the single-process render:
   images within 3e-5 and 1e-5, the Gaussians' gradients of sum(render^2) +
   sum(alpha), with the segment sums' prefix in float64 on both sides (K3's
   float32 prefix path reported beside them), within the JAX package's
   bound between its two rasterizer backends (rtol 2e-3, atol 2e-3 of each
   tensor's largest entry past 1). (e)
   GeoSplatTrainTask with data_parallel on the two ranks at the product
   phase's widths (its triplane at 64 texels) on its scene, 2 steps: only rank 0's run directory exists,
   its export equals its checkpoint, the ranks' losses are equal. Then every
   kernel pass is held against its plain version at rank 0's last camera of
   (c)'s stage-1 step, and its row of the kernels line gains a "scripts_dp"
   entry measured there (launches: rank 0's in its two steps).
The last three lines are the card's name and power limit, the kernels JSON
line and the result JSON line; the line before them gives each phase's
seconds. Without a CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn(): the mean over reps calls queued
    behind a device-side sleep, after one warm-up call. The host enqueues
    all of them while the device sleeps, so the CUDA events bracket device
    time only, not the wrappers' host work (allocation, checks, ctypes); a
    single call bracketed alone measures that host work wherever it exceeds
    the kernel's time. The sleep starts at 1.25x the warm-up call's wall
    time for each call (at ~2 GHz) and grows 4x until the queue outlasts
    the enqueueing. A function that synchronises inside cannot be timed
    so."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cycles = max(20_000_000, int(1.25 * reps * warm_s * 2e9))
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        held = not start.query()   # the sleep still runs: nothing waited on the host
        end.record()
        end.synchronize()
        if held or cycles > 10**10:
            return start.elapsed_time(end) / reps
        cycles *= 4


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


def pair_pixel_counts(pairs, seg_start, grid, n_contrib, kc: int) -> dict:
    """What these inputs need of K1 and K2: the walked (pair, pixel)
    evaluations (each pixel's pairs up to its contributor count), the kept
    ones among them (sigma >= 0 and alpha >= 1/255), all (pair, pixel) of
    the pairs in some tile, the tiles holding a pair and the largest tile;
    and the pairs some pixel walks (each tile's pairs up to its largest
    contributor count) with the chunks of kc that hold them, the only ones
    the compositing passes after K1's products need to read. The suffix_*
    counts are the same past each tile's first chunk, the only part K2's
    suffix pass walks (a tile's first chunk has no earlier chunk to feed);
    multi_chunk_tiles hold more than one chunk. The (pair, pixel) tests run
    on the device over every pair of every tile, in slices of pairs, with no
    padding to the longest tile."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp

    dev = pairs.device
    counts = seg_start[1:] - seg_start[:-1]
    total = int(seg_start[-1])
    tile_of = torch.repeat_interleave(torch.arange(grid.num_tiles, device=dev), counts)
    rank = torch.arange(total, device=dev) - seg_start[tile_of]
    flat = torch.arange(grid.pixels, device=dev)
    kept = kept_late = 0
    step = max(1, (1 << 24) // grid.pixels)
    for s0 in range(0, total, step):
        s1 = min(s0 + step, total)
        t = tile_of[s0:s1, None]
        px = ((t % grid.tw) * grid.tsx + flat % grid.tsx).float() + 0.5
        py = ((t // grid.tw) * grid.tsy + flat // grid.tsx).float() + 0.5
        live = torch.ones((s1 - s0, 1), dtype=torch.bool, device=dev)
        keep = rp._alphas(pairs[s0:s1, None, :], live, px[:, None], py[:, None])[-1][:, 0]
        r = rank[s0:s1, None]
        walked_keep = keep & (r < n_contrib[t[:, 0]])
        kept += int(walked_keep.sum())
        kept_late += int((walked_keep & (r >= kc)).sum())
    walked = torch.minimum(counts, n_contrib.long().amax(-1))
    walked_chunks = (walked + kc - 1) // kc
    return {
        "walked_pairs": int(walked.sum()),
        "walked_chunks": int(walked_chunks.sum()),
        "walked_pair_pixels": int(n_contrib.long().sum()),
        "kept_pair_pixels": kept,
        "suffix_walked_pairs": int((walked - kc).clamp(min=0).sum()),
        "suffix_walked_chunks": int((walked_chunks - 1).clamp(min=0).sum()),
        "suffix_walked_tiles": int((walked > kc).sum()),
        "suffix_pair_pixels": int((n_contrib.long() - kc).clamp(min=0).sum()),
        "suffix_kept_pair_pixels": kept_late,
        "multi_chunk_tiles": int((counts > kc).sum()),
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
    # main path's), C = 14 (stage 3's G-buffer) and the largest register
    # count and spills of any C
    shown = [r for r in report if "ILi3E" in r["kernel"] or "ILi" not in r["kernel"]]
    shown_c14 = [r for r in report if "ILi14E" in r["kernel"]]
    phase("toolchain", nvcc=nvcc, nvidia_smi=smi, build_s=round(build_s, 3),
          libraries=[lib.name for lib in libs], compiled_kernels=len(report),
          max_registers=max((r.get("registers", 0) for r in report), default=0),
          spill_bytes=sum(r["spill_stores"] + r["spill_loads"] for r in report),
          ptxas_c3=shown, ptxas_c14=shown_c14)
    # K1's two passes and combine and K2's two passes for C = 1..16, K3, K4 and
    # K5's forward and backward
    if len(report) != 5 * 16 + 4:
        raise RuntimeError(f"expected 84 compiled kernels in the ptxas report, got {report}")
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


# FP32 operations of one sphere-trace step of one ray (benchmark/opcount.py)
TRACE_OPS_PER_STEP = 88


# FP32 operations of one Monte-Carlo sample's evaluation
# (benchmark/opcount.py EVAL_SAMPLE_OPS); a step takes two, the backward
# twice the forward's
EVAL_SAMPLE_OPS = 150
# K5's bytes a step and point: two directions, MIS weights and visibilities,
# the int64 bank entry and texel
MC_STEP_BYTES = 56


def mc_shade_inputs(device, gen, n: int, steps: int, live_share: float,
                    light_hw: tuple = (256, 512), light_bank: int = 2048):
    """K5's operands as ``env_shade`` makes them, for n points on a shell
    about the origin seen from (0.3, 0.6, 2.8): ([kd, arm, normals, wo, the
    bank's colours, the light's rows], the samples of ``_draw_samples``
    under a visibility that is 0, 1 and between, upstream gradients of
    (diffuse, specular, residual) that are zero past the first live_share of
    the rows: stage 2's padding, stage 3's empty pixels). Every 16th of the
    rows sits on a branch of the step: back-facing normals, n = wo,
    roughness under its clamp, roughness 1."""
    import torch
    import torch.nn.functional as F

    from geosplatting_tpu_torch.graphics import gmath
    from geosplatting_tpu_torch.ops import envshade as es

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    d = F.normalize(torch.randn((n, 3), generator=gen, device=device), dim=-1)
    pos = d * (0.36 + 0.2 * rand(n, 1))
    wo = gmath.safe_normalize(torch.tensor([0.3, 0.6, 2.8], device=device) - pos)
    nrm = F.normalize(0.3 * d + wo, dim=-1)
    k = n // 16
    nrm[:k] = -nrm[:k]
    nrm[k:2 * k] = wo[k:2 * k]
    kd = 0.05 + 0.9 * rand(n, 3)
    arm = torch.stack((0.3 * rand(n), 0.02 + 0.98 * rand(n), rand(n)), -1)
    arm[2 * k:3 * k, 1] = 0.05
    arm[3 * k:4 * k, 1] = 1.0
    h, w = light_hw
    i, j = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                          torch.arange(w, device=device) + 0.5, indexing="ij")
    th, ph = i / h * math.pi, j / w * 2 * math.pi
    lobe = torch.exp(-((th - 0.9) ** 2 + (ph - 2.0) ** 2) * 8.0)
    table = (0.3 + 0.15 * torch.sin(th) * (1 + torch.cos(ph)) + 8.0 * lobe)[..., None] \
        + torch.tensor([0.0, 0.07, 0.14], device=device)
    light = es.compute_light_pdf(table)
    draws = es.draw_shade(n, num_samples_x=round(steps ** 0.5), light_bank=light_bank,
                          generator=gen, device=device)
    m = round(draws.ub.shape[0] ** 0.5)
    cell = torch.arange(m * m, device=device)
    bank_dirs = es.sample_light(light, ((cell % m).float() + draws.ub) / m,
                                ((cell // m).float() + draws.vb) / m)
    bank_pdf = es.light_pdf_at(light, bank_dirs)
    smp = es._draw_samples(light, pos, nrm, wo, kd, arm, bank_dirs, bank_pdf, draws,
                           lambda o, dirs: torch.clamp(0.5 + 0.8 * dirs[..., 1], 0.0, 1.0), 1.0)
    ups = [torch.randn(shape, generator=gen, device=device) for shape in ((n, 3), (n, 3), (n, 2))]
    for u in ups:
        u[int(n * live_share):] = 0
    operands = [kd, arm, nrm, wo, es.eval_light(light, bank_dirs), table.reshape(-1, 3)]
    return operands, smp, ups


def mc_shade_gaps(got, want) -> dict:
    """Forward outputs or gradients of K5 against its plain version: the
    share of entries bit-equal and the largest gap over the tensor's
    largest magnitude."""
    import torch

    if got is None or want is None:
        return {"none": got is None and want is None}
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    return {"bit_equal_share": float((got == want).float().mean()),
            "max_rel_gap": float((got - want).abs().max()) / scale}


# K5 against the plain loop on the card: the forward's three outputs bit for
# bit; each gradient within this share of its largest magnitude (the two sum
# a point's 128 terms, and the light's atomics, in other orders)
TOL_K5_GRAD = 1e-4


def check_mc_shade(device, gen) -> dict:
    """K5 against its plain version at the cells' shapes: stage 2 (786,432
    rows, 42 % live) and stage 3 (640,000 pixels, 12.6 % live), 64 steps, a
    256 x 512 light and a bank of 2,025 directions. Raises where the forward
    is not bit-equal to the plain loop, a gradient's gap passes TOL_K5_GRAD,
    or a call does not launch each kernel once. Returns per shape the gaps,
    the card ms a launch forward and backward, their bounds, and the plain
    loop's ms forward and forward + backward (CUDA events around one call)."""
    import torch

    from geosplatting_tpu_torch import _kernels
    from geosplatting_tpu_torch.ops import envshade as es

    rows = {}
    for name, n, live in (("stage2", 786_432, 0.42), ("stage3", 640_000, 0.126)):
        operands, smp, ups = mc_shade_inputs(device, gen, n, 64, live)
        leaves = [x.requires_grad_() for x in operands]
        before = (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"])
        out = es.mc_shade(*leaves, smp)
        grads = torch.autograd.grad(out, leaves, ups, retain_graph=True)
        launched = (_kernels.launches["mc_shade_fwd"] - before[0],
                    _kernels.launches["mc_shade_bwd"] - before[1])
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        want, _ = es.mc_shade_plain(*leaves, smp)
        events[1].record()
        want_grads = torch.autograd.grad(want, leaves, ups)
        events[2].record()
        events[2].synchronize()
        names = ("diffuse", "specular", "residual", "kd", "arm", "normals", "wo", "bank_cols",
                 "light_rows")
        gaps = {k: mc_shade_gaps(a, b) for k, a, b in zip(names, (*out, *grads),
                                                            (*want, *want_grads))}
        del want, want_grads
        detached = [x.detach() for x in leaves]
        fwd_ms = cuda_ms(lambda: es.mc_shade(*detached, smp), 5)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, ups, retain_graph=True), 5)
        # the backward needs the steps of the rows with an upstream gradient only
        s, live_rows = smp.bidx.shape[0], int(torch.cat(ups, -1).ne(0).any(-1).sum())
        fwd_bound, fwd_by = bound_ms(n * (s * MC_STEP_BYTES + 12 * 4 + 8 * 4),
                                     n * s * 2 * EVAL_SAMPLE_OPS)
        bwd_bound, bwd_by = bound_ms(live_rows * s * MC_STEP_BYTES + n * (12 * 4 + 8 * 4 + 12 * 4),
                                     2 * live_rows * s * 2 * EVAL_SAMPLE_OPS)
        row = {"points": n, "steps": s, "live_share": live, "launches": launched, "gaps": gaps,
               "card_fwd_ms": fwd_ms, "card_bwd_ms": bwd_ms, "fwd_bound_ms": fwd_bound,
               "fwd_bound_by": fwd_by, "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               "plain_fwd_ms": events[0].elapsed_time(events[1]),
               "plain_fwd_bwd_ms": events[0].elapsed_time(events[2]), "tol_grad": TOL_K5_GRAD}
        phase("mc_shade_vs_plain", shape=name, **row)
        rows[name] = row
        fwd_equal = all(gaps[k]["bit_equal_share"] == 1.0 for k in names[:3])
        grads_close = all(g.get("none") or g["max_rel_gap"] <= TOL_K5_GRAD
                          for g in (gaps[k] for k in names[3:]))
        if launched != (1, 1) or not (fwd_equal and grads_close):
            raise AssertionError(f"K5 against its plain version at {name}: {row}")
    return rows


def check_sdf_trace(device, gen) -> dict:
    """K4 against its plain version at the benchmark cells' trace: grid 96,
    scale 0.8, the stage-1 SDF sphere of radius 0.45, a stage-2 batch of
    2^23 rays from a shell about it, 24 steps. Raises past max |dv| 1e-4,
    mean 1e-7, or where the live ray-steps (every ray) differ. Returns the
    errors, the counts, the card ms a launch, its bound (the greater of the
    bytes at 3.35 TB/s and the live ray-steps' operations at 67 TFLOP/s)
    and the plain version's ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geosplatting_tpu_torch import _kernels, counters
    from geosplatting_tpu_torch.ops import sdf_visibility as sv

    r, scale, steps, n = 96, 0.8, 24, 1 << 23
    a = (torch.arange(r + 1.0, device=device) / r * 2 - 1) * scale
    z, y, x = torch.meshgrid(a, a, a, indexing="ij")
    sdf = (torch.sqrt(x * x + y * y + z * z) - 0.45).reshape(-1)
    unit = lambda: torch.nn.functional.normalize(  # noqa: E731
        torch.randn((n, 3), generator=gen, device=device), dim=-1)
    dirs = unit()
    origins = unit() * (0.44 + 0.1 * torch.rand((n, 1), generator=gen, device=device))
    vis = sv.make_sdf_visibility(sdf, (r,) * 3, scale, num_steps=steps)
    plain = sv.make_sdf_visibility_plain(sdf, (r,) * 3, scale, num_steps=steps)
    stride, sv.LIVE_STRIDE = sv.LIVE_STRIDE, 1
    try:
        totals = []
        with profile(activities=[ProfilerActivity.CPU]):
            for fn in (vis, plain):
                counters.reset()
                totals.append((fn(origins, dirs), counters.totals()))
        counters.reset()
    finally:
        sv.LIVE_STRIDE = stride
    (got, kern), (want, ref) = totals
    diff = (got - want).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    launches = _kernels.launches["sdf_trace"]
    card_ms = cuda_ms(lambda: vis(origins, dirs), 10)
    if _kernels.launches["sdf_trace"] - launches < 11:
        raise AssertionError("K4 did not launch once a call")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain(origins, dirs)
    end.record()
    end.synchronize()
    live = kern["sdf_trace.live_ray_steps"]
    bound, by = bound_ms(n * (6 + 1) * 4 + r ** 3 * 8 * 4, live * TRACE_OPS_PER_STEP)
    row = {"shape": [n, 3], "grid": r, "steps": steps, "max_abs_err": max_abs,
           "mean_abs_err": mean_abs, "bit_equal_share": float((got == want).float().mean()),
           "ray_steps": kern["sdf_trace.ray_steps"], "live_ray_steps": live,
           "plain_live_ray_steps": ref["sdf_trace.live_ray_steps"],
           "issued_ray_steps": kern["sdf_trace.issued_ray_steps"], "card_ms": card_ms,
           "bound_ms": bound, "bound_by": by, "plain_ms": start.elapsed_time(end),
           "tol": {"max": 1e-4, "mean": 1e-7}}
    phase("sdf_trace_vs_plain", **row)
    if not (max_abs <= 1e-4 and mean_abs <= 1e-7 and live == ref["sdf_trace.live_ray_steps"]
            and live <= row["issued_ray_steps"] <= row["ray_steps"]):
        raise AssertionError(f"K4 against its plain version: {row}")
    return row


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
    Raises where one disagrees; returns the errors, the kernels' outputs and
    each plain version's milliseconds (CUDA events around its second call).
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
    torch.cuda.synchronize()
    plain_ms = {}

    def plain(name, fn):
        # the plain versions read their tile counts on the host: CUDA events
        # around a call give their time on the device's clock, host work
        # included (queued behind a sleep, a call would wait for it). The
        # second of two calls is timed: the first takes the allocator's
        # new blocks
        out = fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        return out

    prod_p = plain("k1_chunk_products",
                   lambda: rp.chunk_products_plain(pairs, seg_start, grid, chunks))
    out_p, _, nc_p = plain("k1_composite_fwd",
                           lambda: rp.composite_fwd_plain(pairs, seg_start, grid, channels))
    suffix_p = plain("k2_chunk_suffix", lambda: rp.chunk_suffix_plain(
        pairs, seg_start, grid, channels, chunks, grad_out, nc))
    d_p = plain("k2_composite_bwd", lambda: rp.composite_bwd_plain(
        pairs, seg_start, grid, channels, grad_out, tf, nc, pairs.shape[0]))

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
    return {"errors": errors, "checks": checks, "ok": ok, "out": (out, tf, nc, prod, suffix),
            "plain_ms": plain_ms}


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


def write_sphere_scene(root, counts: dict, render_res: int, device) -> None:
    """A Blender-layout scene of the analytic sphere (sphere_gt) under root:
    transforms_<split>.json with views on a circle at height 0.35 x 3 of
    radius 0.94 x 3 (the Blender parser scales them by 2/3), val and test
    views offset by 0.3 of a step, and 800x800 RGBA PNGs rendered at
    render_res and upsampled by pixel replication."""
    import numpy as np

    from geosplatting_tpu_torch.data.dataparsers.blender_family import (
        IMAGE_WH, BlenderDataparser,
    )
    from geosplatting_tpu_torch.data.dataset import cameras_of
    from geosplatting_tpu_torch.data.io import dump_float32_image

    root = Path(root)
    rep = IMAGE_WH // render_res
    for split, num in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(num):
            th = 2 * np.pi * (i + (0.3 if split != "train" else 0)) / num
            eye = 3.0 * np.array([np.cos(th) * 0.94, np.sin(th) * 0.94, 0.35])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        cams = cameras_of(BlenderDataparser().parse(root, split), render_res / IMAGE_WH, device)
        gt = sphere_gt(cams).cpu().numpy()
        for i in range(num):
            dump_float32_image(root / split / f"r_{i}.png",
                               np.kron(gt[i], np.ones((rep, rep, 1), np.float32)))


# the S4R scene of the chain phase: a Lambertian sphere of radius 0.5 and
# albedo S4R_ALBEDO under constant lat-long environments, so that every image
# is a closed form: a convex object under a uniform environment is
# unshadowed, and its radiance is albedo x the environment's radiance
S4R_ALBEDO = (0.6, 0.5, 0.4)
S4R_RADIANCE = {"train": 1.0, "envmap6": 0.7, "envmap12": 1.3}
S4R_ROUGHNESS = 0.5


def sphere_hits(cams):
    """(hit mask [..., H, W, 1] float) of the sphere of radius 0.5 at the origin."""
    origins, dirs = cams.generate_rays()
    b = (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - 0.25
    disc = b * b - c
    hit = (disc > 0) & (-b - (disc.clamp(min=0.0)).sqrt() > 0)
    return hit[..., None].float()


def write_s4r_scene(root, counts: dict, render_res: int, device) -> None:
    """A Syn4Relight-layout scene of the closed-form sphere (S4R_*) under
    root, its environments in root's parent. The stored poses are the
    inverse of the parser's axis swap and 2/3 scale applied to orbit
    cameras around the origin (radius 2, elevation 20 degrees, test views
    offset by 0.3 of a step); the ground truth is rendered at render_res
    from the cameras parsed back, and upsampled to 800 x 800 by pixel
    replication: train/r_i_rgb.hdr (linear albedo x L_train) with
    r_i_mask.png; test/r_i_rgba.png, r_i_albedo.png (sRGB) and r_i_rough.png
    (linear), alpha the mask; test_rli/envmap{6,12}_r_i.png (sRGB);
    ../envmap{6,12}.hdr (16 x 32)."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.dataparsers.blender_family import (
        IMAGE_WH, Syn4RelightDataparser,
    )
    from geosplatting_tpu_torch.data.dataset import cameras_of
    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.graphics import images

    root = Path(root)
    rep = IMAGE_WH // render_res
    albedo = np.asarray(S4R_ALBEDO, np.float32)
    for env in ("envmap6", "envmap12"):
        dump_float32_image(root.parent / f"{env}.hdr",
                           np.full((16, 32, 3), S4R_RADIANCE[env], np.float32))

    def up(img):
        return np.kron(img, np.ones((rep, rep, 1), np.float32))

    def srgb(x):
        return images.rgb2srgb(torch.as_tensor(x)).numpy()

    for split, num in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(num):
            th = 2 * np.pi * (i + (0.3 if split != "train" else 0)) / num
            el = np.deg2rad(20.0)
            eye = 2.0 * np.array([np.cos(th) * np.cos(el), np.sin(el), np.sin(th) * np.cos(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            parsed = np.stack((right, np.cross(right, fwd), -fwd, eye), -1)   # [3, 4], +y up
            parsed[:, 3] *= 1.5              # the parser scales translations by 2/3
            stored = np.eye(4)
            stored[:3] = np.stack((-parsed[2], -parsed[0], parsed[1]))  # rows (-y, z, -x) inverted
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": stored.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    (root / "test_rli").mkdir(exist_ok=True)
    for split, num in counts.items():
        cams = cameras_of(Syn4RelightDataparser().parse(root, split), render_res / IMAGE_WH,
                          device)
        mask = sphere_hits(cams).cpu().numpy()
        for i in range(num):
            m = up(mask[i])
            if split == "train":
                dump_float32_image(root / split / f"r_{i}_rgb.hdr",
                                   albedo * S4R_RADIANCE["train"] * m)
                dump_float32_image(root / split / f"r_{i}_mask.png", m)
                continue
            for name, value in (("rgba", srgb(albedo * S4R_RADIANCE["train"])),
                                ("albedo", srgb(albedo)),   # roughness is stored linear
                                ("rough", np.full(3, S4R_ROUGHNESS, np.float32))):
                dump_float32_image(root / split / f"r_{i}_{name}.png",
                                   np.concatenate((value * m, m), -1))
            for env in ("envmap6", "envmap12"):
                dump_float32_image(root / "test_rli" / f"{env}_r_{i}.png",
                                   np.concatenate((srgb(albedo * S4R_RADIANCE[env]) * m, m), -1))


class Timed:
    """Wraps a function of a class or a module for the duration of a
    with-block: each call is synchronised, its host seconds appended to
    ``seconds`` and its result to ``outputs``. With ``returns_fn`` the
    function it returns is timed as well, into the same ``seconds``."""

    def __init__(self, owner, name, returns_fn=False):
        self.owner, self.name, self.returns_fn = owner, name, returns_fn
        self.fn = getattr(owner, name)
        self.seconds = []
        self.outputs = []

    def timed(self, fn):
        import torch

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        return wrapped

    def __enter__(self):
        timed = self.timed(self.fn)

        def wrapped(*args, **kw):
            out = timed(*args, **kw)
            if self.returns_fn:
                out = self.timed(out)
            self.outputs.append(out)
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


class Recorder:
    """Keeps the arguments of the last call of a kernel wrapper (no launch),
    of the calls whose arguments satisfy ``keep`` when it is given."""

    def __init__(self, module, name, keep=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep = keep
        self.args = None

    def __enter__(self):
        def wrapped(*args):
            if self.keep is None or self.keep(args):
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

    totals = {k: 0 for k in kernels.RASTER_KERNELS}
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
        counts = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
        metrics = {k: float(v) for k, v in m.items()}
        phase("train_step", step=step, sampling=sampling, seconds=round(seconds, 4),
              launches=counts, **{k: metrics[k] for k in (
                  "loss", "reg", "splat_psnr", "nonfinite_grads", "pair_fill", "face_fill",
                  "num_gaussians")})
        if not all(math.isfinite(metrics[k]) for k in ("loss", "reg")):
            raise AssertionError(f"non-finite loss at step {step}: {metrics}")
        if metrics["nonfinite_grads"] != 0 or not metrics["pair_fill"] <= 1.0:
            raise AssertionError(f"step {step}: {metrics}")
        if not (all(counts[k] == batch for k in kernels.RASTER_KERNELS[:4])
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


def measure_kernels(captured, launches: dict, steps: int) -> dict:
    """Each kernel pass at the inputs of its last call in a run (the last
    camera's backward): held to its tolerance against its plain version
    (and K1 and K3 to their own bits on a second run), its launches in that
    run, its device time, the plain version's, its bound for the work these
    inputs need and a library yardstick. Raises where a kernel disagrees."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    (pairs, seg_start, grid, channels, grad_out, _, _, max_pairs, chunks, _, _) = captured["bwd"]
    (k3_in,) = captured["k3"]
    tiles, npx = grid.num_tiles, grid.pixels

    res = check_passes(pairs, seg_start, grid, channels, chunks, grad_out)
    out, t_final, n_contrib, prod, suffix = res["out"]
    # K1 sums no floats atomically: a second run gives the same bits
    again = rp.composite_fwd(pairs, seg_start, grid, channels, chunks,
                             rp.chunk_products(pairs, seg_start, grid, channels, chunks))
    bitwise = all(torch.equal(a, b) for a, b in zip((out, t_final, n_contrib), again))
    k3 = sr.cumsum_rows(k3_in)
    # K3 sums each tile's carry in a fixed order: a second run gives the same bits
    k3_bitwise = bool(torch.equal(k3, sr.cumsum_rows(k3_in)))
    torch.cuda.synchronize()
    k3_rel = float(((k3.double() - torch.cumsum(k3_in.double(), 0)).abs()
                    / (torch.cumsum(k3_in.abs().double(), 0) + 1e-6)).max())
    counts = pair_pixel_counts(pairs, seg_start, grid, n_contrib, chunks.kc)
    n_chunks = int(chunks.tile_chunk_start[-1])
    counts.update(chunks=n_chunks, chunk_slots=int(chunks.chunk_tile.shape[0]), kc=chunks.kc,
                  pairs=int(seg_start[-1]), channels=channels)
    checks = {**res["checks"], "k1_bitwise_repeatable": bitwise,
              "k3_rel_to_abs_prefix": k3_rel, "k3_bitwise_repeatable": k3_bitwise}
    if not (res["ok"] and bitwise and k3_bitwise and k3_rel <= 1e-5):
        raise AssertionError(f"a kernel disagrees with its plain version: {res['errors']} {checks}")

    # bytes each pass must move: inputs read once, outputs written once. K1's
    # products pass reads every pair and writes every chunk's products; the
    # passes after it need only the pairs some pixel walks and their chunks,
    # and K2's suffix pass only those past each tile's first chunk (with the
    # products of the chunks before them) but writes every chunk's suffix
    f = 4
    row = rp.row_stride(channels) * f
    list_bytes = (tiles + 1) * 8 + (tiles + 1) * 4 + chunks.chunk_tile.shape[0] * 4
    per_chunk = n_chunks * npx * f          # prod or suffix of the real chunks
    walked = counts["walked_pairs"] * row + counts["walked_chunks"] * npx * f
    per_tile = tiles * npx * f              # t_final, n_contrib, one row of out or grad_out
    passes = {
        "k1_chunk_products": (
            lambda: rp.chunk_products(pairs, seg_start, grid, channels, chunks),
            int(seg_start[-1]) * row + list_bytes + per_chunk, counts["tile_pair_pixels"],
            counts["kept_pair_pixels"]),
        "k1_composite_fwd": (
            lambda: rp.composite_fwd(pairs, seg_start, grid, channels, chunks, prod),
            walked + list_bytes + per_tile * (channels + 4), counts["walked_pair_pixels"],
            counts["kept_pair_pixels"]),
        "k2_chunk_suffix": (
            lambda: rp.chunk_suffix(pairs, seg_start, grid, channels, chunks, prod, grad_out,
                                    n_contrib),
            (counts["suffix_walked_pairs"] * row + counts["suffix_walked_chunks"] * npx * f
             + per_chunk + list_bytes + counts["multi_chunk_tiles"] * npx * 4
             + counts["suffix_walked_tiles"] * (channels + 2) * npx * f),
            counts["suffix_pair_pixels"], counts["suffix_kept_pair_pixels"]),
        "k2_composite_bwd": (
            lambda: rp.composite_bwd(pairs, seg_start, grid, channels, grad_out, t_final,
                                     n_contrib, max_pairs, chunks, prod, suffix),
            walked + counts["walked_chunks"] * npx * f + list_bytes
            + per_tile * (channels + 4) + max_pairs * (rp.HDR + channels) * f,
            counts["walked_pair_pixels"], counts["kept_pair_pixels"]),
    }
    # the plain versions are timed by their call in the check above;
    # torch.cumsum takes 0.1-0.7 s of device time a call: fewer calls time it
    rows = {}
    for name, (kernel, nbytes, evaluated, kept) in passes.items():
        ops = evaluated * EVAL_OPS + kept * kept_ops(name, channels)
        bound, by = bound_ms(nbytes, ops)
        rows[name] = {
            "launches": launches[name], "launches_per_step": launches[name] / steps,
            "max_abs_err": res["errors"][name],
            "ms": cuda_ms(kernel, 20),
            "plain_ms": res["plain_ms"][name],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bytes": nbytes, "ops": ops, **counts,
        }
    m, c = k3_in.shape
    k3_bound, k3_by = bound_ms(2 * m * c * 4, m * c)
    cumsum = cuda_ms(lambda: torch.cumsum(k3_in, 0), 3)
    rows["k3_cumsum_rows"] = {
        "launches": launches["k3_cumsum_rows"],
        "launches_per_step": launches["k3_cumsum_rows"] / steps,
        "max_abs_err": float((k3 - torch.cumsum(k3_in, 0)).abs().max()),
        "shape": [m, c],
        "ms": cuda_ms(lambda: sr.cumsum_rows(k3_in), 20),
        "plain_ms": cumsum,   # the plain version is torch.cumsum itself
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": cumsum,
        "bitwise_repeatable": k3_bitwise,
    }
    return {"rows": rows, "checks": checks, "counts": counts}


REPLACES = {
    "k1_chunk_products": "geosplatting_tpu/ops/rasterize_pairs.py:483",
    "k1_composite_fwd": "geosplatting_tpu/ops/rasterize_pairs.py:483",
    "k2_chunk_suffix": "geosplatting_tpu/ops/rasterize_pairs.py:548",
    "k2_composite_bwd": "geosplatting_tpu/ops/rasterize_pairs.py:548",
    "k3_cumsum_rows": "geosplatting_tpu/ops/segment_rows.py:31",
}
SOURCES = {
    "k1_chunk_products": "rasterize_fwd.cu", "k1_composite_fwd": "rasterize_fwd.cu",
    "k2_chunk_suffix": "rasterize_bwd.cu", "k2_composite_bwd": "rasterize_bwd.cu",
    "k3_cumsum_rows": "segment_rows.cu",
}
TOLERANCES = {"k1_products": "2e-5 * |x| + 1e-7", "k1_atol": 1e-3, "count_flips": 0.01,
              "k2_atol": "2e-3 * max|x|", "k2_rtol": 2e-3, "k3_rel": 1e-5}


def kernel_line(captured, slice_summary, errors) -> dict:
    """The kernels line at the slice's inputs (phase 5 of the docstring)."""
    import torch

    measured = measure_kernels(captured, slice_summary["launches"], slice_summary["steps"])
    phase("kernels_vs_plain_at_slice", **measured["checks"], **measured["counts"],
          max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
          tol=TOLERANCES)
    entries = []
    for name, row in measured["rows"].items():
        entry = {"name": name, "route": "cuda",
                 "source": f"geosplatting_tpu_torch/csrc/{SOURCES[name]}",
                 "replaces": REPLACES[name], **row}
        if name == "k3_cumsum_rows":
            (k3_in,) = captured["k3"]
            entry["max_abs_err_random_1p4m"] = errors["k3"]
            entry["yardstick"] = {
                "expr": "torch.cumsum(x.t().contiguous(), 1)", "calls": 3,
                "ms": cuda_ms(lambda: torch.cumsum(k3_in.t().contiguous(), 1), 20)}
        else:
            entry["max_abs_err_small_scene"] = errors[name]
        entries.append(entry)
    return {"kernels": entries}


# the SDF starts as the slice's sphere: 6 steps carve no surface out of the
# random init, and stage 2 at the s4r pairs budget needs one (from the
# random init, 89k scattered faces made 8.8M pairs, 5.5x the budget)
PRODUCT = dict(views={"train": 16, "val": 2, "test": 2}, steps=4, save_every=2, resume_to=6,
               sdf_sphere_init=0.45)


def product(device, seed, kernels, tmp: Path) -> dict:
    """The stage-1 product path (phase 6 of the docstring) on a scene written
    under ``tmp``. Raises on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.convert import params_to_numpy
    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask
    from geosplatting_tpu_torch.utils.config import load_dataclass

    t0 = time.perf_counter()
    write_sphere_scene(tmp / "scene", PRODUCT["views"], 800, device)
    scene_s = time.perf_counter() - t0
    task = GeoSplatTrainTask(
        dataset_path=tmp / "scene", experiment_name="product", seed=seed,
        num_steps=PRODUCT["steps"], batch_size=SLICE["cameras"],
        num_steps_per_save=PRODUCT["save_every"], num_steps_per_val=PRODUCT["steps"],
        num_val_images=2, resolution=SLICE["grid"], light_resolution=512,
        scene_scale=0.8, pairs_budget=SLICE["pairs_budget"], device=str(device),
        sdf_sphere_init=PRODUCT["sdf_sphere_init"],
    )
    runs = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Timed(GeoSplatTrainTask, "step_fn") as steps, \
            Timed(GeoSplatTrainTask, "val_render") as val:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        # resume from the last checkpoint, as `resume --dir` does, to 6 steps
        again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                    num_steps=PRODUCT["resume_to"])
        out2 = again.run(resume_dir=run_dir)
        runs.append(out2)
    launches = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
    log = (run_dir / "log.txt").read_text()
    files = sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())
    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{PRODUCT['resume_to']}.pt", map_location="cpu")

    # the export against the last checkpoint's parameters, key by key
    params = params_to_numpy(ckpt["model"])
    want = {**{k: params[k] for k in ("sdf", "deform", "weights", "cubemap", "exposure")},
            "ks_enc/planes": params["field"]["planes"],
            **{f"ks_enc/ks/{k}": v for k, v in params["field"]["ks"].items()},
            "initial_guess": np.array([-3.0, -3.0], np.float32),
            "geom_scale": np.asarray(0.8), "resolution": np.asarray(SLICE["grid"]),
            "min_roughness": np.asarray(0.1), "max_metallic": np.asarray(1.0)}

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    got = dict(flat(exported))
    shapes = {k: list(np.shape(v)) for k, v in got.items()}
    mismatched = sorted(k for k in want if k not in got or not np.array_equal(got[k], want[k]))
    extra = sorted(set(got) - set(want))
    val_psnr = [r["val_psnr"] for r in runs]
    summary = {
        "scene_seconds": scene_s, "output_files": files,
        "val_psnr": val_psnr, "loss": [r["loss"] for r in runs],
        "pair_fill": [r["pair_fill"] for r in runs], "face_fill": [r["face_fill"] for r in runs],
        "step_seconds": steps.seconds, "val_render_seconds": val.seconds,
        "export_shapes": shapes,
        "export_mismatched": mismatched, "export_extra": extra, "launches": launches,
        "resumed": "resumed from step 4" in log, "log_tail": log.splitlines()[-4:],
        "run_dir": str(run_dir),
    }
    phase("product", **summary)
    need = {"task.py", "export.npz", "log.txt", "ckpts/2.pt", "ckpts/4.pt", "ckpts/6.pt"}
    if not (all(math.isfinite(v) for v in val_psnr + summary["loss"])
            and len(steps.seconds) == PRODUCT["resume_to"] and len(val.seconds) == 2
            and not mismatched and not extra and summary["resumed"]
            and f"step {PRODUCT['resume_to']}:" in log and need <= set(files)
            and any(f.startswith("dump/val/") for f in files)
            and all(launches[k] > 0 for k in kernels.RASTER_KERNELS)):
        raise AssertionError(f"the product path failed a check: {summary}")
    return summary


STAGE2 = dict(grid=96, scene_scale=0.8, cameras=8, pairs_budget=1_600_000,
              max_render_faces=1 << 17, num_samples_x=8, shadow_steps=24, denoise=True,
              latlng=[256, 512], steps=1, resume_to=1)


def stage2(device, seed, kernels, scene: Path, load: Path) -> tuple[dict, dict]:
    """Stage 2 from the product phase's stage-1 run (phase 7 of the
    docstring). Returns (summary, the last camera's kernel inputs); raises
    on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.convert import params_to_numpy
    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.engine.train_task import GeoSplatMCTrainTask
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.utils.config import load_dataclass

    task = GeoSplatMCTrainTask(
        dataset_path=scene, experiment_name="stage2", load=load, seed=seed,
        num_steps=STAGE2["steps"], batch_size=STAGE2["cameras"], num_steps_per_save=1,
        num_steps_per_val=STAGE2["steps"], num_val_images=1, resolution=STAGE2["grid"],
        scene_scale=STAGE2["scene_scale"], num_samples_x=STAGE2["num_samples_x"],
        pairs_budget=STAGE2["pairs_budget"], max_render_faces=STAGE2["max_render_faces"],
        device=str(device),
    )
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with Timed(GeoSplatMCTrainTask, "step_fn") as steps, \
            Timed(GeoSplatMCTrainTask, "val_render") as val, \
            Recorder(rp, "composite_bwd") as bwd, Recorder(sr, "cumsum_rows") as k3:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if STAGE2["resume_to"] > STAGE2["steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=STAGE2["resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: kernels.launches[k] for k in kernels.KERNELS}
    log = (run_dir / "log.txt").read_text()
    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{STAGE2['resume_to']}.pt", map_location="cpu")

    # the export against the last checkpoint's parameters, key by key, and
    # its per-Gaussian arrays against gaussian_mask
    params = params_to_numpy(ckpt["model"])
    want = {k: params[k] for k in ("sdf", "deform", "latlng", "exposure")}
    want["ks_enc/planes"] = want["occ_enc/planes"] = params["field"]["planes"]
    for head in ("ks", "occ"):
        want.update({f"{head}_enc/{head}/{k}": v for k, v in params["field"][head].items()})

    def leaf(key):
        node = exported
        for part in key.split("/"):
            node = node[part]
        return node

    mismatched = sorted(k for k in want if not np.array_equal(leaf(k), want[k]))
    mask = exported["gaussian_mask"]
    live = int(mask.sum())
    per_gaussian = ("means", "scales", "quats", "opacities", "normals", "kd", "ks", "occ",
                    "mc_positions")
    mask_ok = bool(mask.shape[0] % 4096 == 0 and mask[:live].all() and not mask[live:].any()
                   and all(exported[k].shape[0] == mask.shape[0] for k in per_gaussian)
                   and (exported["opacities"][live:] == -10).all()
                   and np.isfinite(np.concatenate([exported[k][:live].reshape(live, -1)
                                                   for k in per_gaussian], 1)).all())
    per_step = [{k: float(m[k]) for k in ("loss", "nonfinite_grads", "splat_psnr", "pair_fill",
                                           "face_fill", "num_gaussians", "reg")}
                for m in steps.outputs]
    val_psnr = [r["val_psnr"] for r in runs]
    summary = {
        "config": STAGE2, "steps": per_step, "step_seconds": steps.seconds,
        "val_render_seconds": val.seconds, "val_psnr": val_psnr,
        "live_gaussians": per_step[-1]["num_gaussians"],
        "export_live_gaussians": live, "export_rows": int(mask.shape[0]),
        "export_mismatched": mismatched, "export_mask_ok": mask_ok,
        "peak_memory_gib": peak_gib, "launches": launches,
        "resumed": f"resumed from step {STAGE2['steps']}" in log,
        "log_tail": log.splitlines()[-3:],
    }
    phase("stage2", **summary)
    finite = all(math.isfinite(v) for v in val_psnr
                 + [m[k] for m in per_step for k in ("loss", "splat_psnr", "reg")])
    if not (finite and len(per_step) == STAGE2["resume_to"] and len(val.seconds) == len(runs)
            and all(m["nonfinite_grads"] == 0 for m in per_step)
            and all(m["pair_fill"] <= 1.0 and m["face_fill"] <= 1.0 for m in per_step)
            and (summary["resumed"] or len(runs) == 1)
            and f"step {STAGE2['resume_to']}:" in log
            and not mismatched and mask_ok and live > 0
            and all(launches[k] > 0 for k in kernels.KERNELS)):
        raise AssertionError(f"stage 2 failed a check: {summary}")
    return summary, {"bwd": bwd.args, "k3": k3.args}


# the chain phase: stage 1 -> 2 -> 3 -> reliteval through the tasks the CLIs
# build from their s4r-twosphere presets, on the closed-form S4R scene
CHAIN = dict(views={"train": 16, "test": 2}, stage1_steps=2, stage2_steps=1, stage3_steps=1,
             stage3_resume_to=1, sdf_sphere_init=0.45)
F32_01, F32_99 = 0.009999999776482582, 0.9900000095367432   # float32(0.01), float32(0.99)


def chain(device, seed, kernels, tmp: Path) -> tuple[dict, dict]:
    """Phase 8 of the docstring. Returns (summary, the last G-buffer
    camera's kernel inputs); raises on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.convert import params_to_numpy
    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.engine.train_task import (
        MESH_TILE_CAPACITY, GeoSplatDeferTrainTask,
    )
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.scripts import train_geosplat as cli1
    from geosplatting_tpu_torch.scripts import train_geosplat_defer as cli3
    from geosplatting_tpu_torch.scripts import train_geosplat_mc as cli2
    from geosplatting_tpu_torch.utils.config import load_dataclass

    c = CHAIN
    scene = tmp / "s4r" / "scene"
    t0 = time.perf_counter()
    write_s4r_scene(scene, c["views"], 800, device)
    scene_s = time.perf_counter() - t0
    common = dict(dataset_path=scene, seed=seed, device=str(device), num_val_images=1)
    t0 = time.perf_counter()
    out1 = dataclasses.replace(
        cli1.TASKS["s4r-twosphere"], experiment_name="chain-s1", num_steps=c["stage1_steps"],
        num_steps_per_save=c["stage1_steps"], num_steps_per_val=c["stage1_steps"],
        sdf_sphere_init=c["sdf_sphere_init"], **common).run()
    out2 = dataclasses.replace(
        cli2.TASKS["s4r-twosphere"], experiment_name="chain-s2", num_steps=c["stage2_steps"],
        num_steps_per_save=c["stage2_steps"], num_steps_per_val=c["stage2_steps"],
        load=Path(out1["output_dir"]).resolve(), **common).run()
    stages12_s = time.perf_counter() - t0

    preset3 = cli3.TASKS["s4r-twosphere"]
    task = dataclasses.replace(
        preset3, experiment_name="chain-s3", num_steps=c["stage3_steps"], num_steps_per_save=1,
        num_steps_per_val=c["stage3_steps"], load=Path(out2["output_dir"]).resolve(), **common)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = []
    with Timed(GeoSplatDeferTrainTask, "step_fn") as steps, \
            Timed(GeoSplatDeferTrainTask, "val_render") as val, \
            Recorder(rp, "composite_bwd", keep=lambda a: a[3] == 14) as bwd, \
            Recorder(sr, "cumsum_rows", keep=lambda a: a[0].shape[1] == 7 + 14) as k3:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if c["stage3_resume_to"] > c["stage3_steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=c["stage3_resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: kernels.launches[k] for k in kernels.KERNELS}
    log = (run_dir / "log.txt").read_text()
    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{c['stage3_resume_to']}.pt", map_location="cpu")

    # the export against the last checkpoint's parameters, key by key
    params = params_to_numpy(ckpt["model"])
    want = {k: v for k, v in params.items() if k != "ks_enc"}
    want["ks_enc/planes"] = params["ks_enc"]["planes"]
    want.update({f"ks_enc/ks/{k}": v for k, v in params["ks_enc"]["ks"].items()})

    def leaf(key):
        node = exported["params"]
        for part in key.split("/"):
            node = node[part]
        return node

    mismatched = sorted(k for k in want if not np.array_equal(leaf(k), want[k]))
    kd, hue = exported["params"]["kd"], exported["params"]["latlng_hue"]
    clamps = {"kd": [float(kd.min()), float(kd.max())],
              "latlng_hue": [float(hue.min()), float(hue.max())]}
    clamps_ok = all(F32_01 <= lo and hi <= F32_99 for lo, hi in clamps.values())
    per_step = [{k: float(m[k]) for k in ("loss", "reg", "splat_psnr", "nonfinite_grads",
                                           "pair_fill", "mesh_tile_fill", "mesh_pair_fill",
                                           "num_gaussians", "exposure")}
                for m in steps.outputs]

    t0 = time.perf_counter()
    ev = dataclasses.replace(cli3.TASKS["reliteval"], load=run_dir, dataset_path=scene,
                             device=str(device))
    results = ev.run()
    eval_s = time.perf_counter() - t0
    eval_json = json.loads((run_dir / "eval.json").read_text())
    numbers = [v for r in eval_json.values()
               for v in (r.values() if isinstance(r, dict) else r if isinstance(r, list) else [r])]
    eval_finite = bool(numbers) and all(isinstance(v, float) and math.isfinite(v)
                                        for v in numbers)
    summary = {
        "config": {**c, "preset": {k: getattr(preset3, k) for k in (
            "resolution", "scene_scale", "batch_size", "pairs_budget", "num_samples_x")},
            "shadow_steps": 24, "mesh_tile_capacity": MESH_TILE_CAPACITY,
            "image": [800, 800]},
        "scene_seconds": scene_s, "stages_1_2_seconds": stages12_s,
        "stage2_run_dir": str(Path(out2["output_dir"]).resolve()),
        "stage2_val_psnr": out2["val_psnr"], "stage3_steps": per_step,
        "stage3_step_seconds": steps.seconds, "stage3_val_render_seconds": val.seconds,
        "stage3_val_psnr": [r["val_psnr"] for r in runs], "peak_memory_gib": peak_gib,
        "launches": launches, "export_mismatched": mismatched, "export_clamps": clamps,
        "eval": results, "eval_seconds": eval_s,
        "expected_relit_srgb": {env: [round(float(x), 4) for x in np.where(
            np.asarray(S4R_ALBEDO) * S4R_RADIANCE[env] <= 0.0031308,
            np.asarray(S4R_ALBEDO) * S4R_RADIANCE[env] * 12.92,
            1.055 * (np.asarray(S4R_ALBEDO) * S4R_RADIANCE[env]) ** (1 / 2.4) - 0.055)]
            for env in ("envmap6", "envmap12")},
        "resumed": f"resumed from step {c['stage3_steps']}" in log,
        "log_tail": log.splitlines()[-3:],
    }
    phase("chain", **summary)
    finite = all(math.isfinite(m[k]) for m in per_step for k in ("loss", "reg", "splat_psnr"))
    if not (finite and len(per_step) == c["stage3_resume_to"]
            and len(val.seconds) == len(runs)
            and all(m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1.0
                    and m["mesh_tile_fill"] <= 1.0 and m["mesh_pair_fill"] <= 1.0
                    for m in per_step)
            and (summary["resumed"] or len(runs) == 1)
            and f"step {c['stage3_resume_to']}:" in log
            and not mismatched and clamps_ok and eval_finite
            and {"nvs", "relight/envmap6", "relight/envmap12", "albedo"} <= set(eval_json)
            and all(launches[k] > 0 for k in kernels.KERNELS)
            and bwd.args is not None and k3.args is not None):
        raise AssertionError(f"the chain failed a check: {summary}")
    return summary, {"bwd": bwd.args, "k3": k3.args}


# the gsplat phase: bench.py's second workload (bench.py:80-122) at its
# widths, then SH degree 3 with densification, then the 3DGS task
GSPLAT = dict(gaussians=50_000, cameras=8, resolution=800, radius=2.5, elevation=15.0,
              random_scale=0.8, opacity_logit=1.0, pairs_per_gaussian=32, warmup_steps=4,
              timed_steps=10, sh_steps=4, densify_steps=(12, 14), reset_step=2,
              densify_quantile=0.9, task_steps=4, task_resume_to=6)


def trace_step(step, spans=("gsplat.", "rasterize.")) -> dict:
    """One synchronised call of step() under torch.profiler: its wall time,
    the device's busy time (the sum of its kernels' times; the profiler also
    lists the record_function spans, named with the prefixes ``spans``, as
    device events), the idle share and the five kernels with the most device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(spans)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": max(0.0, 1 - busy / wall),
            "kernel_launches": len(kernels), "top_kernels_s": dict(top)}


def gsplat_scene(device, gen, sh_degree: int, **model_kw):
    """bench.py's 3DGS scene at GSPLAT's widths: random Gaussians at
    opacity logit 1, the model on black (with ``model_kw``), the orbit
    cameras and the horizontal-gradient ground truth. Returns (splats,
    model, cams, gt)."""
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.graphics.splats import Splats
    from geosplatting_tpu_torch.models.gsplatter import GSplatter

    c = GSPLAT
    b, res = c["cameras"], c["resolution"]
    splats = Splats.random(c["gaussians"], sh_degree=sh_degree,
                           random_scale=c["random_scale"], generator=gen, device=device)
    splats = splats.replace(opacities=torch.full_like(splats.opacities, c["opacity_logit"]))
    model = GSplatter(**{"sh_degree": sh_degree, "background_color": "black",
                         "pairs_per_gaussian": c["pairs_per_gaussian"], "device": device,
                         **model_kw})
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=c["radius"],
                              elevation_degrees=c["elevation"], num_samples=b, width=res,
                              height=res, device=device)
    gt = torch.linspace(0, 1, res, device=device)[None, None, :, None].expand(
        b, res, res, 4).contiguous()
    return splats, model, cams, gt


def gsplat_bench(device, seed, kernels) -> tuple[dict, dict]:
    """(a) of phase 9: 50k random Gaussians (SH degree 0, opacity logit 1),
    8 orbit cameras at 800x800 on black, bench.py's horizontal-gradient
    ground truth, GSplatTrainer with densification off; warm-up and timed
    steps. Returns (summary, the last camera's kernel inputs)."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    c = GSPLAT
    b = c["cameras"]
    gen = torch.Generator(device=device).manual_seed(seed)
    splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=0)
    trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=b, warmup_length=10**9), model,
                            dataset_size=b)
    trainer.init_state(splats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, per_step, totals = [], [], {k: 0 for k in kernels.RASTER_KERNELS}
    recorders = [Recorder(rp, "composite_bwd"), Recorder(sr, "cumsum_rows")]
    n_steps = c["warmup_steps"] + c["timed_steps"]
    for i in range(n_steps):
        timed = i >= c["warmup_steps"]
        if i == n_steps - 1:
            for r in recorders:
                r.__enter__()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(cams, gt, max_sh_degree=None, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
        metrics = {k: float(v) for k, v in m.items()}
        per_step.append({**metrics, "seconds": dt, "timed": timed})
        if not (math.isfinite(metrics["loss"]) and metrics["nonfinite_grads"] == 0
                and metrics["pair_fill"] <= 1.0):
            raise AssertionError(f"gsplat step {i}: {metrics}")
        if not all(counts[k] == b for k in kernels.RASTER_KERNELS):
            raise AssertionError(f"gsplat step {i}: kernel launches {counts} for {b} cameras")
        if timed:
            seconds.append(dt)
            for k in totals:
                totals[k] += counts[k]
    for r in recorders:
        r.__exit__()
    peak = torch.cuda.max_memory_allocated() / 2**30
    traced = trace_step(lambda: trainer.train_step(cams, gt, max_sh_degree=None, generator=gen))
    with torch.no_grad():
        pairs = [int(model.render_rgba(trainer.splats(), cams[i])[1]["total_pairs"])
                 for i in range(b)]
    med = sorted(seconds)[len(seconds) // 2]
    budget = c["pairs_per_gaussian"] * c["gaussians"]
    summary = {
        "config": {k: c[k] for k in ("gaussians", "cameras", "resolution", "radius",
                                     "elevation", "random_scale", "opacity_logit",
                                     "pairs_per_gaussian", "warmup_steps", "timed_steps")},
        "pair_budget": budget, "pairs_per_camera": pairs,
        "pairs_per_gaussian_needed": max(pairs) / c["gaussians"],
        "pair_fill": max(pairs) / budget, "timed_step_seconds": seconds,
        "median_step_s": med, "its": 1.0 / med, "peak_memory_gib": peak, "traced": traced,
        "loss": [s["loss"] for s in per_step], "launches": totals,
        "launches_per_step": {k: v / c["timed_steps"] for k, v in totals.items()},
    }
    return summary, {"bwd": recorders[0].args, "k3": recorders[1].args}


def gsplat_densify(device, seed) -> dict:
    """(b) of phase 9: the same scene at SH degree 3, trained with
    max_sh_degree 3, then after_update at a reset step and two densify
    steps (refine every 2, reset every 20, the densify threshold at this
    run's 90th percentile of the averaged screen gradient, so a tenth of the
    Gaussians split). After each: the count is param_map's, the kept slots
    hold the old rows and Adam moments, the new slots zero moments, and the
    next step is finite."""
    import dataclasses

    import torch

    from geosplatting_tpu_torch.graphics.splats import FIELDS
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    c = GSPLAT
    b, res = c["cameras"], c["resolution"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=3)
    trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=b, warmup_length=1, refine_every=2,
                                                reset_alpha_every=10), model, dataset_size=b)
    trainer.init_state(splats)

    def step():
        m = {k: float(v) for k, v in trainer.train_step(cams, gt, max_sh_degree=3,
                                                       generator=gen).items()}
        if not (math.isfinite(m["loss"]) and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1):
            raise AssertionError(f"gsplat SH-3 step: {m}")
        return m

    steps = [step() for _ in range(c["sh_steps"])]
    events = []
    for at in (c["reset_step"], *c["densify_steps"]):
        old = {k: p.detach().clone() for k, p in trainer.params.items()}
        moments = {k: {m: s.clone() for m, s in trainer.optimizers.adam.state[
            trainer.params[k]].items() if m != "step"} for k in trainer.specs}
        vis = torch.clamp(trainer.vis_counts, min=1.0)
        avg = 0.5 * res * (trainer.xys_grad_norm / vis)
        thresh = float(torch.quantile(avg, c["densify_quantile"]))
        trainer.config = dataclasses.replace(trainer.config, densify_grad_thresh=thresh)
        info = trainer.after_update(at, (res, res), generator=gen)
        n_old, n_new = old["means"].shape[0], trainer.params["means"].shape[0]
        event = {"step": at, "before": n_old, "after": n_new, "densify_grad_thresh": thresh,
                 "reset_opacities": info["reset_opacities"]}
        ok = info is not None
        pmap = info["param_map"]
        if pmap is None:   # the reset step: opacities clamped, their moments cleared
            limit = math.log(0.2 / 0.8)
            st = trainer.optimizers.adam.state[trainer.params["opacities"]]
            ok = ok and info["reset_opacities"] and n_new == n_old and bool(
                (trainer.params["opacities"] <= limit + 1e-6).all()) and not bool(
                st["exp_avg"].any() or st["exp_avg_sq"].any())
        else:
            kept = pmap >= 0
            src = pmap[kept]
            event.update(kept=int(kept.sum()), new=int((~kept).sum()),
                         dropped_or_split=n_old - int(kept.sum()))
            ok = ok and n_new == pmap.shape[0] and n_new != n_old and all(
                torch.equal(trainer.params[k].detach()[kept], old[k][src]) for k in FIELDS)
            for k in trainer.specs:
                st = trainer.optimizers.adam.state[trainer.params[k]]
                for m in ("exp_avg", "exp_avg_sq"):
                    ok = ok and torch.equal(st[m][kept], moments[k][m][src]) and not bool(
                        st[m][~kept].any())
        event["next_step"] = step()
        events.append(event)
        if not ok:
            raise AssertionError(f"gsplat densification failed a check: {event}")
    return {"sh_steps": steps, "events": events,
            "final_gaussians": int(trainer.params["means"].shape[0])}


def gsplat_task(device, seed, kernels, scene: Path) -> dict:
    """(c) of phase 9: GSplatTrainTask at the blender preset's widths on the
    product phase's scene: 4 steps with checkpoints at 2 and 4, validation
    and the export, a resume to 6, the export held against the step-6
    checkpoint key by key."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.engine.train_task import GSplatTrainTask
    from geosplatting_tpu_torch.scripts import train_gsplat as cli
    from geosplatting_tpu_torch.utils.config import load_dataclass

    c = GSPLAT
    preset = cli.TASKS["blender"]
    task = dataclasses.replace(preset, dataset_path=scene, experiment_name="gsplat-task",
                               seed=seed, num_steps=c["task_steps"], num_steps_per_save=2,
                               num_steps_per_val=c["task_steps"], num_val_images=2,
                               device=str(device))
    torch.cuda.synchronize()
    kernels.reset_launches()
    runs = []
    with Timed(GSplatTrainTask, "step_fn") as steps, Timed(GSplatTrainTask, "val_render") as val:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if c["task_resume_to"] > c["task_steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=c["task_resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    launches = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
    log = (run_dir / "log.txt").read_text()
    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{c['task_resume_to']}.pt", map_location="cpu")
    params = {k: v.numpy() for k, v in ckpt["params"].items()}
    mismatched = sorted(k for k in params if not np.array_equal(exported.get(k), params[k]))
    per_step = [{k: float(m[k]) for k in ("loss", "psnr", "nonfinite_grads", "pair_fill",
                                           "num_gaussians")} for m in steps.outputs]
    summary = {
        "preset": {k: getattr(preset, k) for k in ("num_init_gaussians", "sh_degree",
                                                   "batch_size", "rasterize_mode",
                                                   "pairs_per_gaussian")},
        "steps": per_step, "step_seconds": steps.seconds, "val_render_seconds": val.seconds,
        "val_psnr": [r["val_psnr"] for r in runs],
        "export_shapes": {k: list(v.shape) for k, v in exported.items()},
        "export_mismatched": mismatched, "launches": launches,
        "resumed": f"resumed from step {c['task_steps']}" in log,
        "log_tail": log.splitlines()[-3:],
    }
    if not (all(math.isfinite(m["loss"]) and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1
                for m in per_step)
            and len(per_step) == c["task_resume_to"] and len(val.seconds) == 2
            and all(math.isfinite(v) for v in summary["val_psnr"])
            and summary["resumed"] and f"step {c['task_resume_to']}:" in log
            and not mismatched and sorted(exported) == sorted(params)
            and all(launches[k] > 0 for k in kernels.RASTER_KERNELS)):
        raise AssertionError(f"the 3DGS task failed a check: {summary}")
    return summary


# phase 10: the mesh prior at the defining scale of scripts/prior_scale_demo.py
PRIOR = dict(rows=300, cols=280, radius=0.5, scale=1.0, num_samples_x=4, shadow_scale=0.95,
             visibility_resolution=64, denoise=True, pairs_budget=2_500_000, resolution=800,
             cam_radius=2.0, elevation=20.0, cameras=4, batch=2, warmup_steps=1, timed_steps=2,
             hash_steps=1, task_rows=120, task_cols=112, task_steps=1, task_resume_to=1)
PRIOR_SPANS = ("trainer.", "prior.", "envshade.", "geosplat.", "rasterize.")


def uv_sphere(rows: int, cols: int, radius: float = 0.5, device=None):
    """The UV sphere of scripts/prior_scale_demo.py:43-63: (rows + 1) rings
    of cols vertices from polar angle 1e-3 to pi - 1e-3, two triangles a
    quad, the columns wrapped: 2 x rows x cols faces."""
    import torch

    from geosplatting_tpu_torch.graphics.mesh import TriangleMesh

    th = torch.linspace(1e-3, math.pi - 1e-3, rows + 1, dtype=torch.float64)
    ph = torch.arange(cols, dtype=torch.float64) * (2 * math.pi / cols)
    tt, pp = torch.meshgrid(th, ph, indexing="ij")
    v = torch.stack((tt.sin() * pp.cos(), tt.cos(), tt.sin() * pp.sin()), -1).reshape(-1, 3)
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    c1 = (c + 1) % cols
    i00, i01, i10, i11 = r * cols + c, r * cols + c1, (r + 1) * cols + c, (r + 1) * cols + c1
    f = torch.cat((torch.stack((i00, i10, i01), -1).reshape(-1, 3),
                   torch.stack((i01, i10, i11), -1).reshape(-1, 3)))
    return TriangleMesh(vertices=(v * radius).float().to(device), indices=f.to(device))


def prior_train(device, seed, kernels, hash_field: bool) -> tuple[dict, dict]:
    """(a) and (b) of phase 10: GeoSplatterPrior on the 300 x 280 UV sphere
    (1,008,000 Gaussians) at 800x800, batch 2, through GeoSplatPriorTrainer,
    with the shared field (a: warm-up and timed steps, one step traced) or
    the hash field (b: timed steps). The timed steps run uninstrumented;
    one more step records each camera's pairs and the last camera's kernel
    inputs, and times the visibility grid's build and march synchronised.
    Gates on every step. Returns (summary, the last camera's kernel
    inputs)."""
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.models import geosplat_prior
    from geosplatting_tpu_torch.models.geosplat import GaussianField
    from geosplatting_tpu_torch.models.geosplat_mc import OCC_ENC
    from geosplatting_tpu_torch.models.geosplat_prior import GeoSplatterPrior
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.train.geosplat_prior_trainer import (
        GeoSplatPriorTrainer, GeoSplatPriorTrainerConfig,
    )

    c = PRIOR
    b = c["batch"]
    gen = torch.Generator(device=device).manual_seed(seed + (7 if hash_field else 5))
    mesh = uv_sphere(c["rows"], c["cols"], c["radius"], device)
    field = GaussianField(occ_enc=OCC_ENC, generator=gen, device=device) if hash_field else None
    model = GeoSplatterPrior(
        mesh, scale=c["scale"], num_samples_x=c["num_samples_x"],
        shadow_scale=c["shadow_scale"], visibility_resolution=c["visibility_resolution"],
        denoise=c["denoise"], pairs_budget=c["pairs_budget"], field=field, generator=gen,
        device=device)
    trainer = GeoSplatPriorTrainer(GeoSplatPriorTrainerConfig(batch_size=b), model)
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=c["cam_radius"],
                              elevation_degrees=c["elevation"], num_samples=c["cameras"],
                              width=c["resolution"], height=c["resolution"], device=device)
    gt = sphere_gt(cams)
    deform0 = model.deform.detach().clone()
    n_steps = c["hash_steps"] if hash_field else c["warmup_steps"] + c["timed_steps"]
    n_warm = 0 if hash_field else c["warmup_steps"]
    per_step, seconds, totals = [], [], {k: 0 for k in kernels.RASTER_KERNELS}

    def step(i):
        idx = (torch.arange(b, device=device) + i * b) % c["cameras"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(cams[idx], gt[idx], generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
        metrics = {k: float(v) for k, v in m.items()}
        per_step.append({**metrics, "seconds": dt, "launches": counts})
        if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["reg"])
                and metrics["nonfinite_grads"] == 0 and metrics["pair_fill"] <= 1.0):
            raise AssertionError(f"prior step {i} (hash={hash_field}): {metrics}")
        if not all(counts[k] == b for k in kernels.RASTER_KERNELS):
            raise AssertionError(f"prior step {i}: kernel launches {counts} for {b} cameras")
        return dt, counts

    # the median and the peak memory come from uninstrumented steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        dt, counts = step(i)
        if i >= n_warm:
            seconds.append(dt)
            for k in totals:
                totals[k] += counts[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step, instrumented: each camera's pairs, the last camera's
    # kernel inputs, the occupancy grid's build and its march synchronised
    with Timed(GeoSplatterPrior, "render") as renders, \
            Timed(geosplat_prior, "make_mesh_visibility", returns_fn=True) as vis, \
            Recorder(rp, "composite_bwd") as bwd, Recorder(sr, "cumsum_rows") as k3:
        instrumented_s, _ = step(n_steps)
    traced = None if hash_field else trace_step(
        lambda: trainer.train_step(cams[:b], gt[:b], generator=gen), spans=PRIOR_SPANS)
    pairs = [int(out[2]["total_pairs"]) for out in renders.outputs]
    med = sorted(seconds)[len(seconds) // 2]
    vis_s = sum(vis.seconds)
    n_live = int(per_step[-1]["num_gaussians"])
    summary = {
        "field": "hash" if hash_field else "shared",
        "config": {k: c[k] for k in ("rows", "cols", "radius", "scale", "num_samples_x",
                                     "shadow_scale", "visibility_resolution", "denoise",
                                     "pairs_budget", "resolution", "cam_radius", "elevation",
                                     "batch")},
        "faces": mesh.num_faces, "num_gaussians": n_live,
        "pairs_per_camera": pairs, "pairs_per_gaussian": max(pairs) / n_live,
        "pair_fill": [s["pair_fill"] for s in per_step],
        "step_seconds": [s["seconds"] for s in per_step[:n_steps]], "median_step_s": med,
        "loss": [s["loss"] for s in per_step], "reg": [s["reg"] for s in per_step],
        "peak_memory_gib": peak, "launches": totals,
        "deform_moved": float((model.deform.detach() - deform0).abs().max()),
        "instrumented_step_s": instrumented_s,
        "instrumented_render_forward_seconds": renders.seconds,
        "instrumented_visibility_seconds": vis_s,
        "instrumented_visibility_share": vis_s / instrumented_s,
        "traced": traced,
    }
    if not (n_live == 6 * mesh.num_faces and summary["deform_moved"] > 0 and len(pairs) == b
            and len(vis.outputs) == b and bwd.args is not None and k3.args is not None):
        raise AssertionError(f"the prior phase failed a check: {summary}")
    return summary, {"bwd": bwd.args, "k3": k3.args}


def prior_task(device, seed, kernels, scene: Path, tmp: Path) -> dict:
    """(c) of phase 10: GeoSplatPriorTrainTask at the object preset's widths
    on the product phase's scene, its prior the 120 x 112 UV sphere written
    as binary PLY: PRIOR's task steps with checkpoints, validation and the
    export, a resume, the export held against the last checkpoint key by
    key."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.engine.train_task import GeoSplatPriorTrainTask
    from geosplatting_tpu_torch.graphics.mesh_io import load_mesh, save_mesh
    from geosplatting_tpu_torch.scripts import train_geosplat_prior as cli
    from geosplatting_tpu_torch.utils.config import load_dataclass

    c = PRIOR
    mesh = uv_sphere(c["task_rows"], c["task_cols"], c["radius"])
    mesh_path = tmp / "prior_uv_sphere.ply"
    save_mesh(mesh_path, mesh.vertices.numpy(), mesh.indices.numpy().astype(np.int32))
    base = load_mesh(mesh_path)
    preset = cli.TASKS["object"]
    task = dataclasses.replace(preset, dataset_path=scene, mesh_path=mesh_path,
                               experiment_name="prior-task", seed=seed,
                               num_steps=c["task_steps"], num_steps_per_save=1,
                               num_steps_per_val=c["task_steps"], num_val_images=2,
                               device=str(device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = []
    with Timed(GeoSplatPriorTrainTask, "step_fn") as steps, \
            Timed(GeoSplatPriorTrainTask, "val_render") as val:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if c["task_resume_to"] > c["task_steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=c["task_resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
    log = (run_dir / "log.txt").read_text()
    export = prior_export_check(run_dir, base, c["task_resume_to"])
    per_step = [{k: float(m[k]) for k in ("loss", "reg", "nonfinite_grads", "pair_fill",
                                           "num_gaussians")} for m in steps.outputs]
    summary = {
        "preset": {k: getattr(preset, k) for k in ("num_steps", "batch_size", "scene_scale",
                                                   "tile_capacity", "num_samples_x",
                                                   "backend")},
        "mesh": {"faces": len(base["indices"]), "vertices": len(base["vertices"]),
                 "gaussians": 6 * len(base["indices"])},
        "steps": per_step, "step_seconds": steps.seconds, "val_render_seconds": val.seconds,
        "val_psnr": [r["val_psnr"] for r in runs], "peak_memory_gib": peak,
        **export, "launches": launches, "resumed": f"resumed from step {c['task_steps']}" in log,
        "log_tail": log.splitlines()[-3:],
    }
    if not (all(math.isfinite(m["loss"]) and math.isfinite(m["reg"])
                and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1 for m in per_step)
            and len(per_step) == c["task_resume_to"] and len(val.seconds) == len(runs)
            and all(math.isfinite(v) for v in summary["val_psnr"])
            and (summary["resumed"] or len(runs) == 1)
            and f"step {c['task_resume_to']}:" in log
            and export["export_ok"] and all(launches[k] > 0 for k in kernels.RASTER_KERNELS)):
        raise AssertionError(f"the prior task failed a check: {summary}")
    return summary


def prior_export_check(run_dir: Path, base: dict, step: int) -> dict:
    """A prior run's export against its step-``step`` checkpoint key by key
    (the prior mesh ``base`` plus the offsets), every per-Gaussian row
    finite, ``sdf`` and ``mc_face_mask`` None."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.convert import params_to_numpy
    from geosplatting_tpu_torch.engine.stage_io import load_export

    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{step}.pt", map_location="cpu")
    params = params_to_numpy(ckpt["model"])
    want = {"latlng": params["latlng"], "exposure": params["exposure"],
            "ks_enc/planes": params["field"]["planes"],
            "mc_vertices": base["vertices"] + params["deform"],
            "mc_indices": base["indices"],
            **{f"ks_enc/ks/{k}": v for k, v in params["field"]["ks"].items()}}

    def leaf(key):
        node = exported
        for part in key.split("/"):
            node = node[part]
        return node

    mismatched = sorted(k for k in want if not np.array_equal(leaf(k), want[k]))
    n_gauss = 6 * len(base["indices"])
    per_gaussian = ("means", "scales", "quats", "opacities", "normals", "kd", "ks", "occ",
                    "mc_positions")
    rows_ok = all(exported[k].shape[0] == n_gauss and np.isfinite(exported[k]).all()
                  for k in per_gaussian)
    sdf_none = exported["sdf"] is None and exported["mc_face_mask"] is None
    return {"export_mismatched": mismatched, "export_rows_ok": rows_ok,
            "export_sdf_none": sdf_none, "export_ok": not mismatched and rows_ok and sdf_none}


# phase 11: 2DGS on bench.py's 3DGS scene at the gsplat phase's widths, the
# depth render modes there, and the blender-2dgs task on the product scene.
# The fullest tile holds ~1,950-2,000 Gaussians at 32 pairs a Gaussian (CPU
# count of bin_gaussians on this scene), so the tile capacity is the 2DGS
# task's, which leaves a quarter of headroom
GSPLAT2D = dict(pairs_per_gaussian=32, tile_capacity=2560, warmup_steps=1, timed_steps=2,
                task_steps=2, task_resume_to=3)
SPANS_2D = ("gsplat.", "rasterize.")


def gsplat2d_train(device, seed) -> dict:
    """(a) of phase 11: GSplatTrainer in 2dgs mode with both regularisers
    at their JAX weights: warm-up and timed steps (uninstrumented: median
    s/step, peak memory), one instrumented step (the compositing's forward
    and the backward synchronised: their share of the step) and one traced
    step (busy time, idle share, leading device operations). Gates on every
    step: finite loss, normal loss and distortion, no non-finite gradient,
    pair_fill and tile_fill <= 1 (the largest of the cameras')."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_2dgs as r2d
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    c, c2 = GSPLAT, GSPLAT2D
    b = c["cameras"]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=0, rasterize_mode="2dgs",
                                           pairs_per_gaussian=c2["pairs_per_gaussian"],
                                           tile_capacity=c2["tile_capacity"])
    trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=b, warmup_length=10**9), model,
                            dataset_size=b)
    trainer.init_state(splats)
    reg = (trainer.config.normal_weight, trainer.config.distort_weight)
    keys = ("loss", "psnr", "normal_loss", "distort_loss", "nonfinite_grads", "pair_fill",
            "tile_fill")

    def step():
        m = {k: float(v) for k, v in trainer.train_step(
            cams, gt, max_sh_degree=None, reg_weights=reg, generator=gen).items()}
        if not (all(math.isfinite(m[k]) for k in ("loss", "normal_loss", "distort_loss"))
                and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1 and m["tile_fill"] <= 1):
            raise AssertionError(f"2DGS step: {m}")
        return {k: m[k] for k in keys}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, per_step = [], []
    for i in range(c2["warmup_steps"] + c2["timed_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_step.append(step())
        torch.cuda.synchronize()
        if i >= c2["warmup_steps"]:
            seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the instrumented step: the compositing's forward and the backward
    # (recomputation and gradients of the compositing, the SSIM's and the
    # projection's) synchronised
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Timed(r2d, "composite_tiles_2dgs") as fwd, Timed(torch.Tensor, "backward") as bwd:
        per_step.append(step())
    instrumented = time.perf_counter() - t0
    traced = trace_step(step, SPANS_2D)
    with torch.no_grad():
        infos = [model.render_rgba(trainer.splats(), cams[i])[1] for i in range(b)]
    pairs = [int(info["total_pairs"]) for info in infos]
    fullest = [int(info["max_tile_pairs"]) for info in infos]
    med = sorted(seconds)[len(seconds) // 2]
    return {
        "config": {**{k: c[k] for k in ("gaussians", "cameras", "resolution", "radius",
                                        "elevation", "random_scale", "opacity_logit")},
                   **{k: c2[k] for k in ("pairs_per_gaussian", "tile_capacity",
                                         "warmup_steps", "timed_steps")},
                   "reg_weights": reg},
        "steps": per_step, "timed_step_seconds": seconds, "median_step_s": med,
        "peak_memory_gib": peak, "pairs_per_camera": pairs,
        "pairs_per_gaussian_needed": max(pairs) / c["gaussians"],
        "fullest_tile_per_camera": fullest,
        "tile_fill": max(fullest) / c2["tile_capacity"],
        "instrumented_step_s": instrumented, "composite_forward_s": sum(fwd.seconds),
        "backward_s": sum(bwd.seconds),
        "composite_forward_share": sum(fwd.seconds) / instrumented,
        "backward_share": sum(bwd.seconds) / instrumented, "traced": traced,
    }


def gsplat2d_depth(device, seed, kernels) -> tuple[dict, dict]:
    """(b) of phase 11: render_depth in both modes on the 2DGS scene, each
    camera's expected depth finite and, where alpha > 0.5, inside the
    camera's depth range: classic, between its nearest and farthest
    Gaussian centre (an expected depth is a weighted mean of theirs); 2dgs,
    between the camera's near and far planes (a disk seen edge-on is hit
    far from its centre, and the low-pass keeps such hits; the share
    outside the centres' range is reported); then one classic ED render
    differentiated, its K1-K3 launches counted and K2's inputs, with a
    non-zero depth gradient, recorded. Returns (summary, the kernels'
    inputs)."""
    import torch

    from geosplatting_tpu_torch.models.gsplatter import GSplatter
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    c, c2 = GSPLAT, GSPLAT2D
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    splats, model_2d, cams, _ = gsplat_scene(device, gen, sh_degree=0, rasterize_mode="2dgs",
                                             pairs_per_gaussian=c2["pairs_per_gaussian"],
                                             tile_capacity=c2["tile_capacity"])
    model = GSplatter(sh_degree=0, background_color="black",
                      pairs_per_gaussian=c["pairs_per_gaussian"], device=device)
    summary = {"modes": {}}
    with torch.no_grad():
        for name, m in (("classic", model), ("2dgs", model_2d)):
            outside, beyond_centres, covered, lo_hi = 0, 0, 0, []
            for i in range(len(cams)):
                cam = cams[i]
                depth = m.render_depth(splats, cam)
                z = (splats.means @ cam.view_matrix[:3, :3].T + cam.view_matrix[:3, 3])[:, 2]
                z = z[(z > cam.near) & (z < cam.far)]
                ed = depth[..., 0][depth[..., 1] > 0.5]
                if not bool(torch.isfinite(depth).all()):
                    raise AssertionError(f"render_depth ({name}) is not finite")
                off = (ed < z.min() - 1e-4) | (ed > z.max() + 1e-4)
                beyond_centres += int(off.sum())
                outside += int(off.sum() if name == "classic"
                               else ((ed <= cam.near) | (ed >= cam.far)).sum())
                covered += ed.numel()
                lo_hi.append([float(ed.min()), float(ed.max()), float(z.min()), float(z.max())])
            summary["modes"][name] = {
                "covered_pixels": covered, "outside_range": outside,
                "share_beyond_centres": beyond_centres / max(covered, 1),
                "ed_and_centre_range_per_camera": lo_hi}
            if outside or not covered:
                raise AssertionError(f"render_depth ({name}): {summary['modes'][name]}")
    # one differentiated classic ED render (the last camera): K2 sees the
    # depth row of its gradient. The loss is the weighted mean over the
    # covered pixels (alpha > 0.5): ED = D / alpha, so nearly empty pixels
    # would scale the gradient by up to 1e10
    w = torch.rand((c["resolution"], c["resolution"], 1), generator=gen, device=device)
    means = splats.means.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Recorder(rp, "composite_bwd") as bwd, Recorder(sr, "cumsum_rows") as k3:
        depth = model.render_depth(splats.replace(means=means), cams[len(cams) - 1])
        covered = depth[..., 1:] > 0.5
        ((depth[..., :1] * w * covered).sum() / covered.sum()).backward()
        torch.cuda.synchronize()
    launches = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
    channels = bwd.args[3]
    grad_out = bwd.args[4]
    summary.update(launches=launches,
                   depth_grad_max=float(grad_out[:, channels].abs().max()),
                   means_grad_finite=bool(torch.isfinite(means.grad).all()),
                   means_grad_max=float(means.grad.abs().max()))
    if not (summary["depth_grad_max"] > 0 and summary["means_grad_finite"]
            and summary["means_grad_max"] > 0
            and all(launches[k] > 0 for k in kernels.RASTER_KERNELS)):
        raise AssertionError(f"the differentiated ED render failed a check: {summary}")
    return summary, {"bwd": bwd.args, "k3": k3.args}


def gsplat2d_task(device, seed, scene: Path, tmp: Path) -> dict:
    """(c) of phase 11: GSplatTrainTask at the blender-2dgs preset on the
    product phase's scene: 2 steps with a checkpoint, validation and the
    export, a resume to 3, the export held against the step-3 checkpoint
    key by key, and the export written as a splat PLY and read back."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.convert import splats_from_numpy, splats_to_numpy
    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.engine.train_task import GSplatTrainTask
    from geosplatting_tpu_torch.graphics.splats_io import export_splats_ply, import_splats_ply
    from geosplatting_tpu_torch.scripts import train_gsplat as cli
    from geosplatting_tpu_torch.utils.config import load_dataclass

    c = GSPLAT2D
    preset = cli.TASKS["blender-2dgs"]
    task = dataclasses.replace(preset, dataset_path=scene, experiment_name="gsplat2d-task",
                               seed=seed, num_steps=c["task_steps"],
                               num_steps_per_save=c["task_steps"],
                               num_steps_per_val=c["task_steps"], num_val_images=2,
                               device=str(device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with Timed(GSplatTrainTask, "step_fn") as steps, Timed(GSplatTrainTask, "val_render") as val:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if c["task_resume_to"] > c["task_steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=c["task_resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log = (run_dir / "log.txt").read_text()
    exported = load_export(run_dir)
    ckpt = torch.load(run_dir / "ckpts" / f"{c['task_resume_to']}.pt", map_location="cpu")
    params = {k: v.numpy() for k, v in ckpt["params"].items()}
    mismatched = sorted(k for k in params if not np.array_equal(exported.get(k), params[k]))
    ply = tmp / "gsplat2d.ply"
    export_splats_ply(splats_from_numpy(exported), ply)
    back = splats_to_numpy(import_splats_ply(ply, device="cpu"))
    q = exported["quats"] / np.linalg.norm(exported["quats"], axis=-1, keepdims=True)
    ply_ok = bool(all(np.array_equal(back[k], exported[k])
                      for k in ("means", "scales", "opacities", "shs"))
                  and np.abs(back["colors"] - exported["colors"]).max() <= 1e-6
                  and np.abs(back["quats"] - q).max() <= 1e-6)
    keys = ("loss", "psnr", "normal_loss", "distort_loss", "nonfinite_grads", "pair_fill",
            "tile_fill", "num_gaussians")
    per_step = [{k: float(m[k]) for k in keys} for m in steps.outputs]
    summary = {
        "preset": {k: getattr(preset, k) for k in ("num_init_gaussians", "sh_degree",
                                                   "batch_size", "rasterize_mode",
                                                   "pairs_per_gaussian", "tile_capacity")},
        "steps": per_step, "step_seconds": steps.seconds, "val_render_seconds": val.seconds,
        "val_psnr": [r["val_psnr"] for r in runs], "peak_memory_gib": peak,
        "export_shapes": {k: list(v.shape) for k, v in exported.items()},
        "export_mismatched": mismatched, "ply_bytes": ply.stat().st_size,
        "ply_round_trip": ply_ok, "resumed": f"resumed from step {c['task_steps']}" in log,
        "log_tail": log.splitlines()[-3:],
    }
    if not (all(math.isfinite(m["loss"]) and math.isfinite(m["normal_loss"])
                and math.isfinite(m["distort_loss"]) and m["nonfinite_grads"] == 0
                and m["pair_fill"] <= 1 and m["tile_fill"] <= 1 for m in per_step)
            and len(per_step) == c["task_resume_to"] and len(val.seconds) == 2
            and all(math.isfinite(v) for v in summary["val_psnr"])
            and summary["resumed"] and f"step {c['task_resume_to']}:" in log
            and not mismatched and sorted(exported) == sorted(params) and ply_ok):
        raise AssertionError(f"the 2DGS task failed a check: {summary}")
    return summary


def check_2dgs_card_vs_cpu(device, seed) -> dict:
    """(d) of phase 11: one 2DGS train step with both regularisers (2,000
    anisotropic Gaussians, 2 cameras at 64x64) on the card and on the CPU
    from the same state and background: the metrics within 1e-3, every
    gradient and the screen-space statistic by the card-vs-CPU rule (< 3 %
    of entries off by more than 5e-3 + 5e-3 |g|, cosine > 0.999: the two
    devices round differently and a cutoff may flip)."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.graphics.splats import FIELDS, Splats
    from geosplatting_tpu_torch.models.gsplatter import GSplatter
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    g = torch.Generator().manual_seed(seed + 3)
    splats = Splats.random(2000, sh_degree=1, random_scale=0.8, generator=g, device="cpu")
    splats = splats.replace(shs=torch.randn(splats.shs.shape, generator=g) * 0.1,
                            scales=splats.scales + torch.randn((2000, 3), generator=g) * 0.4,
                            colors=torch.rand((2000, 3), generator=g),
                            opacities=torch.full_like(splats.opacities, 1.0))
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.5, elevation_degrees=15.0,
                              num_samples=2, width=64, height=64, device="cpu")
    gt = torch.rand((2, 64, 64, 4), generator=g)
    out = []
    for dev in ("cpu", device):
        trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=2), GSplatter(
            sh_degree=1, rasterize_mode="2dgs", tile_capacity=GSPLAT2D["tile_capacity"],
            device=dev), 2)
        trainer.init_state(Splats(**{k: getattr(splats, k).to(dev) for k in FIELDS}))
        m = trainer.train_step(cams.to(dev), gt.to(dev), max_sh_degree=1,
                               reg_weights=(0.05, 0.01),
                               background=torch.tensor([0.2, 0.5, 0.7], device=dev))
        grads = {k: p.grad.detach().cpu().numpy() for k, p in trainer.params.items()
                 if p.grad is not None}
        grads["xys_grad_norm"] = trainer.xys_grad_norm.cpu().numpy()
        out.append(({k: float(v) for k, v in m.items()}, grads))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out
    result = {"metrics_cpu": m_cpu, "metrics_card": m_gpu, "grads": {}}
    ok = m_gpu["nonfinite_grads"] == 0 and m_gpu["tile_fill"] <= 1
    for k in ("loss", "psnr", "normal_loss", "distort_loss", "pair_fill", "tile_fill"):
        ok = ok and abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * abs(m_cpu[k]) + 1e-7
    for k, want in g_cpu.items():
        got = g_gpu[k].astype(np.float64)
        want = want.astype(np.float64)
        off = float((np.abs(got - want) > 5e-3 + 5e-3 * np.abs(want)).mean())
        cos = float((got * want).sum() / max(np.linalg.norm(got) * np.linalg.norm(want), 1e-300))
        result["grads"][k] = {"share_off": off, "cosine": cos}
        ok = ok and bool(np.isfinite(got).all()) and off < 0.03 and cos > 0.999
    phase("gsplat2d_card_vs_cpu", **result, ok=ok)
    if not ok:
        raise AssertionError("the card's 2DGS step disagrees with the CPU path")
    return result


# phase 12: the capture layouts, each written here at its real layout's
# image size: mip-NeRF 360's garden at images_4 (COLMAP, 1297 x 840),
# Stanford-ORB's blender_LDR (2048 x 2048, read at half size), DTU's masked
# IDR (1600 x 1200, read at 0.4) with an off-centre principal point, and the
# MeshPBR layout at 800. Stanford-ORB's pairs budget is the product phase's
# 1.4M scaled by its pixels, (1024 / 800)^2.
CAPTURES = dict(
    colmap_wh=(1297, 840), colmap_views=24, colmap_points=10_000, colmap_focal=1100.0,
    colmap_radius=2.2, colmap_elevation=20.0, prior_steps=1, prior_resume_to=1,
    orb_views={"train": 16, "test": 2}, orb_pairs_budget=2_400_000,
    dtu_wh=(1600, 1200), dtu_views=10, dtu_k=(2892.0, 2892.0, 880.0, 560.0),
    stage1=dict(num_steps=2, batch_size=8, resolution=SLICE["grid"], light_resolution=512,
                scene_scale=0.8, sdf_sphere_init=PRODUCT["sdf_sphere_init"]),
    centroid_px=1.0,
    pbr_rows=200, pbr_cols=192, pbr_views=(8, 2, 2), pbr_resolution=800,
    card_vs_cpu_px_share=0.01, geometry_points=100_000, geometry_resolution=128,
    check_resolution=64, dpsr_chamfer=0.1, tsdf_chamfer=0.025,
)


class Launches(Timed):
    """``Timed``, and each call's kernel launches in ``launches`` (the
    counts are reset as each call starts)."""

    def __init__(self, owner, name, kernels):
        super().__init__(owner, name)
        self.kernels, self.launches = kernels, []

    def timed(self, fn):
        inner = super().timed(fn)

        def wrapped(*args, **kw):
            self.kernels.reset_launches()
            out = inner(*args, **kw)
            self.launches.append({k: self.kernels.launches[k] for k in self.kernels.RASTER_KERNELS})
            return out

        return wrapped

    def totals(self) -> dict:
        return {k: sum(c[k] for c in self.launches) for k in self.kernels.RASTER_KERNELS}


def _rot_to_qvec(r):
    """A rotation matrix's unit quaternion (w, x, y, z), w >= 0."""
    import numpy as np

    w = math.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2, r[2, 1] - r[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - r[0, 0] + r[1, 1] - r[2, 2])) / 2, r[0, 2] - r[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - r[0, 0] - r[1, 1] + r[2, 2])) / 2, r[1, 0] - r[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def write_colmap_scene(root: Path, device, seed: int) -> None:
    """A COLMAP scene of the analytic sphere (sphere_gt) under root:
    sparse/0/{cameras,images,points3D}.bin with one PINHOLE camera at
    1297 x 840 (the centred principal point and one focal, what the parser
    keeps), CAPTURES' views on an orbit as images/frame_<i>.png (RGB, the
    sphere on white), and points on the sphere."""
    import dataclasses
    import struct

    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    c = CAPTURES
    w, h = c["colmap_wh"]
    n = c["colmap_views"]
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=c["colmap_radius"],
                              elevation_degrees=c["colmap_elevation"], num_samples=n,
                              width=w, height=h, device=device)
    f = torch.full((n,), c["colmap_focal"], device=device)
    cams = dataclasses.replace(cams, fx=f, fy=f, cx=torch.full_like(f, w / 2.0),
                               cy=torch.full_like(f, h / 2.0))
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, w, h))
        fh.write(struct.pack("<4d", c["colmap_focal"], c["colmap_focal"], w / 2.0, h / 2.0))
    c2w = cams.c2w.double().cpu().numpy()
    with open(sparse / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", n))
        for i in range(n):
            r_cv = c2w[i, :, :3] * np.array([1.0, -1.0, -1.0])   # to COLMAP's camera
            r = r_cv.T                                           # world to camera
            fh.write(struct.pack("<I", i + 1))
            fh.write(struct.pack("<4d", *_rot_to_qvec(r)))
            fh.write(struct.pack("<3d", *(-r @ c2w[i, :, 3])))
            fh.write(struct.pack("<I", 1))
            fh.write(f"frame_{i:03d}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    g = torch.Generator().manual_seed(seed + 12)
    d = torch.randn((c["colmap_points"], 3), generator=g, dtype=torch.float64)
    xyz = (0.5 * d / d.norm(dim=-1, keepdim=True)).numpy()
    rgb = (np.clip(xyz + 0.5, 0, 1) * 255).astype(np.uint8)
    with open(sparse / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            fh.write(struct.pack("<Q3d3BdQ", i, *xyz[i], *rgb[i], 0.5, 0))
    for i in range(n):
        gt = sphere_gt(cams[i:i + 1])[0].cpu().numpy()
        # a capture has no alpha: the sphere on white, the background the
        # task's validation composites its renders on
        dump_float32_image(root / "images" / f"frame_{i:03d}.png",
                           gt[..., :3] + 1.0 - gt[..., 3:])


def write_orb_scene(root: Path, device) -> Path:
    """A Stanford-ORB scene of the analytic sphere: blender_LDR/sphere with
    2048 x 2048 RGB frames and their masks (rendered at the parser's size
    and upsampled by pixel replication), transforms as the product scene's
    (views on a circle, translations 3/2 of the parser's), and
    ground_truth/sphere/mesh_blender/mesh.obj. Returns the scene."""
    import numpy as np

    from geosplatting_tpu_torch.data.dataparsers.real_captures import StanfordORBDataparser
    from geosplatting_tpu_torch.data.dataset import cameras_of
    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.graphics.mesh_io import save_mesh

    scene = root / "blender_LDR" / "sphere"
    for split, num in CAPTURES["orb_views"].items():
        (scene / split).mkdir(parents=True)
        (scene / f"{split}_mask").mkdir()
        frames = []
        for i in range(num):
            th = 2 * np.pi * (i + (0.3 if split != "train" else 0)) / num
            eye = 3.0 * np.array([np.cos(th) * 0.94, np.sin(th) * 0.94, 0.35])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(right, fwd), -fwd, eye
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()})
        meta = json.dumps({"camera_angle_x": 0.8, "frames": frames})
        (scene / f"transforms_{split}.json").write_text(meta)
        if split == "test":
            (scene / "transforms_novel.json").write_text(meta)
    gt_dir = root / "ground_truth" / "sphere" / "mesh_blender"
    gt_dir.mkdir(parents=True)
    sphere = uv_sphere(60, 64, 0.5 * 1.5)
    save_mesh(gt_dir / "mesh.obj", sphere.vertices.numpy(), sphere.indices.numpy())
    parser = StanfordORBDataparser()
    rep = round(1 / parser.scale_factor)
    for split in CAPTURES["orb_views"]:
        cams = cameras_of(parser.parse(scene, split), None, device)
        for i in range(len(cams)):
            gt = sphere_gt(cams[i:i + 1])[0]
            big = gt.repeat_interleave(rep, 0).repeat_interleave(rep, 1).cpu().numpy()
            dump_float32_image(scene / split / f"r_{i}.png", big[..., :3])
            dump_float32_image(scene / f"{split}_mask" / f"r_{i}.png", big[..., 3:])
    return scene


def write_dtu_scene(root: Path, device) -> None:
    """A masked-IDR (DTU) scene of the analytic sphere under root: views on
    a partial dome of radius 3 looking at the origin (the parser's fitted
    sphere), cameras_large.npz of the projections K [R | t] with CAPTURES'
    off-centre K, 1600 x 1200 RGB frames image/<i:06d>.png and masks
    mask/<i:03d>.png."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    c = CAPTURES
    w, h = c["dtu_wh"]
    fx, fy, cx, cy = c["dtu_k"]
    k = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    n = c["dtu_views"]
    mats, c2ws = {}, []
    for i in range(n):
        az = math.radians(-60.0 + 120.0 * i / (n - 1))
        el = math.radians(30.0 + 10.0 * (i % 2))
        eye = 3.0 * np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
                              math.sin(el)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        r = np.stack((right, down, fwd))        # world to the OpenCV camera
        p = np.eye(4)
        p[:3, :3] = k @ r
        p[:3, 3] = k @ (-r @ eye)
        mats[f"world_mat_{i}"] = p
        mats[f"scale_mat_{i}"] = np.eye(4)
        c2ws.append(np.stack((right, -down, -fwd, eye), -1))
    np.savez(root / "cameras_large.npz", **mats)

    def full(v):
        return torch.full((n,), v, device=device)

    cams = Cameras(c2w=torch.as_tensor(np.stack(c2ws), dtype=torch.float32, device=device),
                   fx=full(fx), fy=full(fy), cx=full(cx), cy=full(cy), width=w, height=h)
    for i in range(n):
        gt = sphere_gt(cams[i:i + 1])[0].cpu().numpy()
        dump_float32_image(root / "image" / f"{i:06d}.png", gt[..., :3])
        dump_float32_image(root / "mask" / f"{i:03d}.png", gt[..., 3:])


def captures_prior(device, seed, kernels, tmp: Path) -> tuple[dict, dict]:
    """(a) of phase 12: the prior's unbounded preset (batch 4, scene scale
    2.0) through the CLI's task on the COLMAP scene, its prior the 300 x 280
    UV sphere of phase 10 (a) as PLY: CAPTURES' steps with checkpoints,
    validation and the export, a resume, the export held against the last
    checkpoint. Gates on every step; returns (summary, the last camera's
    kernel inputs)."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.dataset import recognize_dataparser
    from geosplatting_tpu_torch.engine.train_task import GeoSplatPriorTrainTask
    from geosplatting_tpu_torch.graphics.mesh_io import load_mesh, save_mesh
    from geosplatting_tpu_torch.models.geosplat_prior import GeoSplatterPrior
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.scripts import train_geosplat_prior as cli
    from geosplatting_tpu_torch.utils.config import load_dataclass

    c = CAPTURES
    t0 = time.perf_counter()
    scene = tmp / "garden"
    write_colmap_scene(scene, device, seed)
    mesh = uv_sphere(PRIOR["rows"], PRIOR["cols"], PRIOR["radius"])
    mesh_path = tmp / "prior_garden.ply"
    save_mesh(mesh_path, mesh.vertices.numpy(), mesh.indices.numpy().astype(np.int32))
    base = load_mesh(mesh_path)
    scene_s = time.perf_counter() - t0
    layout = type(recognize_dataparser(scene)).__name__
    preset = cli.TASKS["unbounded"]
    task = dataclasses.replace(preset, dataset_path=scene, mesh_path=mesh_path,
                               experiment_name="prior-unbounded", seed=seed,
                               num_steps=c["prior_steps"], num_steps_per_save=1,
                               num_steps_per_val=c["prior_steps"], num_val_images=2,
                               device=str(device))
    fullest = []

    def fullest_tile(args):
        seg_start = args[1]
        fullest.append(int((seg_start[1:] - seg_start[:-1]).max()))
        return True

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with Launches(GeoSplatPriorTrainTask, "step_fn", kernels) as steps, \
            Timed(GeoSplatPriorTrainTask, "val_render") as val, \
            Timed(GeoSplatterPrior, "render") as renders, \
            Recorder(rp, "composite_bwd", fullest_tile) as bwd, \
            Recorder(sr, "cumsum_rows") as k3:
        out = task.run()
        run_dir = Path(out["output_dir"]).resolve()
        runs.append(out)
        if c["prior_resume_to"] > c["prior_steps"]:   # a resume to resume_to
            again = dataclasses.replace(load_dataclass(run_dir / "task.py"),
                                        num_steps=c["prior_resume_to"])
            runs.append(again.run(resume_dir=run_dir))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log = (run_dir / "log.txt").read_text()
    export = prior_export_check(run_dir, base, c["prior_resume_to"])
    b = preset.batch_size
    per_step = [{k: float(m[k]) for k in ("loss", "reg", "nonfinite_grads", "pair_fill",
                                           "num_gaussians")} for m in steps.outputs]
    pairs = [int(o[2]["total_pairs"]) for o in renders.outputs if o[0].shape[0] == 1]
    n_gauss = 6 * len(base["indices"])
    summary = {
        "layout": layout, "scene_seconds": scene_s,
        "preset": {k: getattr(preset, k) for k in ("batch_size", "scene_scale",
                                                   "num_samples_x", "num_steps")},
        "image_wh": list(c["colmap_wh"]), "gaussians": n_gauss,
        "steps": per_step, "step_seconds": steps.seconds,
        "median_step_s": sorted(steps.seconds)[len(steps.seconds) // 2],
        "val_render_seconds": val.seconds, "val_psnr": [r["val_psnr"] for r in runs],
        "peak_memory_gib": peak, "pairs_per_camera": pairs,
        "pairs_per_gaussian": max(pairs) / n_gauss, "fullest_tile_per_camera": fullest,
        **export, "launches_per_step": steps.launches, "launches": steps.totals(),
        "resumed": f"resumed from step {c['prior_steps']}" in log,
    }
    if not (layout == "ColmapDataparser"
            and all(math.isfinite(m["loss"]) and math.isfinite(m["reg"])
                    and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1 for m in per_step)
            and all(all(n == b for n in counts.values()) for counts in steps.launches)
            and len(per_step) == c["prior_resume_to"] and len(pairs) == b * len(per_step)
            and all(math.isfinite(v) for v in summary["val_psnr"])
            and (summary["resumed"] or len(runs) == 1)
            and export["export_ok"] and bwd.args is not None and k3.args is not None):
        raise AssertionError(f"the COLMAP prior run failed a check: {summary}")
    return summary, {"bwd": bwd.args, "k3": k3.args}


def captures_stage1(device, seed, kernels, scene: Path, name: str, pairs_budget: int
                    ) -> tuple[dict, list]:
    """(b) and (c) of phase 12: GeoSplatTrainTask at the product phase's
    widths on a capture scene, 2 steps and a validation. Gates on every
    step; returns (summary, the validation's renders)."""
    import torch

    from geosplatting_tpu_torch.data.dataset import recognize_dataparser
    from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask

    c = CAPTURES["stage1"]
    layout = type(recognize_dataparser(scene)).__name__
    task = GeoSplatTrainTask(
        dataset_path=scene, experiment_name=f"captures-{name}", seed=seed,
        num_steps_per_save=c["num_steps"], num_steps_per_val=c["num_steps"], num_val_images=2,
        pairs_budget=pairs_budget, device=str(device), **c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Launches(GeoSplatTrainTask, "step_fn", kernels) as steps, \
            Timed(GeoSplatTrainTask, "val_render") as val:
        out = task.run()
    run_s = time.perf_counter() - t0
    per_step = [{k: float(m[k]) for k in ("loss", "reg", "splat_psnr", "nonfinite_grads",
                                           "pair_fill", "face_fill")} for m in steps.outputs]
    summary = {"layout": layout, "pairs_budget": pairs_budget, "steps": per_step,
               "step_seconds": steps.seconds,
               "median_step_s": sorted(steps.seconds)[len(steps.seconds) // 2],
               "run_seconds": run_s, "val_render_seconds": val.seconds,
               "val_psnr": out.get("val_psnr"), "image_hw": list(val.outputs[-1].shape[1:3]),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches_per_step": steps.launches, "launches": steps.totals()}
    b = c["batch_size"]
    if not (all(math.isfinite(m["loss"]) and math.isfinite(m["reg"])
                and m["nonfinite_grads"] == 0 and m["pair_fill"] <= 1 and m["face_fill"] <= 1
                for m in per_step)
            and all(all(n[k] == b for k in kernels.RASTER_KERNELS[:4])
                    and all(n[k] >= b for k in kernels.RASTER_KERNELS[4:]) for n in steps.launches)
            and len(per_step) == c["num_steps"] and math.isfinite(summary["val_psnr"])):
        raise AssertionError(f"the {name} run failed a check: {summary}")
    return summary, val.outputs


def silhouette_check(device, scene: Path, renders) -> dict:
    """(c)'s check that the per-camera intrinsics reached the projection:
    the alpha-weighted centroid of each validation render (and of its
    ground-truth mask) against the origin, the sphere's centre, projected
    with the camera's own fx, fy, cx, cy."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.dataset import Dataset

    cams, images, _ = Dataset(scene, device=device).get_split("val")
    idx = np.linspace(0, len(cams) - 1, len(renders)).astype(np.int64)
    out = []
    for i, pred in zip(idx, renders):
        cam = cams[int(i)]
        p = cam.view_matrix[:3, 3]            # the origin in the camera's frame
        centre = [float(cam.fx * p[0] / p[2] + cam.cx), float(cam.fy * p[1] / p[2] + cam.cy)]
        row = {"principal_point": [float(cam.cx), float(cam.cy)], "projected_centre": centre,
               "image_centre": [cam.width / 2.0, cam.height / 2.0]}
        for name, alpha in (("render", pred[..., 3]),
                            ("gt_mask", torch.as_tensor(images[int(i)][..., 3], device=device))):
            ys = torch.arange(alpha.shape[0], device=device, dtype=torch.float64) + 0.5
            xs = torch.arange(alpha.shape[1], device=device, dtype=torch.float64) + 0.5
            a = alpha.double()
            cxy = [float((a.sum(0) * xs).sum() / a.sum()), float((a.sum(1) * ys).sum() / a.sum())]
            row[f"{name}_centroid"] = cxy
            row[f"{name}_offset_px"] = math.hypot(cxy[0] - centre[0], cxy[1] - centre[1])
        out.append(row)
    off_centre = [math.hypot(r["principal_point"][0] - r["image_centre"][0],
                             r["principal_point"][1] - r["image_centre"][1]) for r in out]
    ok = (all(r["render_offset_px"] <= CAPTURES["centroid_px"] for r in out)
          and min(off_centre) > 5 * CAPTURES["centroid_px"])
    result = {"views": out, "principal_point_off_centre_px": off_centre,
              "tol_px": CAPTURES["centroid_px"], "ok": ok}
    if not ok:
        raise AssertionError(f"the silhouettes miss the projected centres: {result}")
    return result


def write_spot(root: Path) -> Path:
    """The MeshPBR layout's spot/spot.obj: a CAPTURES-sized UV sphere,
    faces wound outward, with vertex colours."""
    import numpy as np

    from geosplatting_tpu_torch.graphics.mesh_io import save_mesh

    m = uv_sphere(CAPTURES["pbr_rows"], CAPTURES["pbr_cols"], 1.0)
    v, f = m.vertices.numpy(), m.indices.numpy().astype(np.int32)
    normals, _ = m.face_normals_and_areas()
    if float((normals * m.face_vertices().mean(-2)).sum()) < 0:
        f = f[:, ::-1].copy()
    colors = np.clip(0.5 + 0.4 * v, 0.0, 1.0).astype(np.float32)
    (root / "spot").mkdir(parents=True)
    save_mesh(root / "spot" / "spot.obj", v, f, colors=colors)
    return root / "spot"


def captures_pbr(device, tmp: Path) -> dict:
    """(d) of phase 12: MeshPBRDataparser at 800 on write_spot's mesh under
    an HDR environment (a lat-long sky gradient with a sun, written as .hdr
    by data/io.py), CAPTURES' view counts: seconds a view, the mesh
    raster's fills on every view, every image finite with some alpha, and
    the first val view on the card against the CPU (the share of pixels
    off by more than 1e-3 at most CAPTURES' card_vs_cpu_px_share: a winner
    flips at a shared edge's depth tie where the devices round apart)."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.dataparsers.synthetic_meshes import (
        TILE_CAPACITY, MeshPBRDataparser,
    )
    from geosplatting_tpu_torch.data.dataset import Dataset, recognize_dataparser
    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.ops import mesh_raster

    c = CAPTURES
    path = write_spot(tmp / "meshes")
    th = (np.arange(128) + 0.5) / 128 * np.pi
    ph = (np.arange(256) + 0.5) / 256 * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sky = 0.4 + 0.8 * np.clip(np.cos(tt), 0, None)[..., None] * np.array([0.6, 0.8, 1.0])
    sun = 40.0 * np.exp(-((tt - 0.6) ** 2 + (pp - 2.0) ** 2) / 0.01)[..., None]
    env_path = tmp / "sky.hdr"
    dump_float32_image(env_path, (sky + sun).astype(np.float32))
    n_train, n_val, n_test = c["pbr_views"]
    parser = MeshPBRDataparser(resolution=c["pbr_resolution"], num_train_views=n_train,
                               num_val_views=n_val, num_test_views=n_test,
                               envmap_path=str(env_path), device=device)
    ds = Dataset(path, dataparser=parser, device=device)
    layout = type(recognize_dataparser(path)).__name__
    seconds, views, images = {}, {}, {}
    with Timed(mesh_raster, "rasterize_mesh") as rast:
        for split in ("train", "val", "test"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cams, imgs, meta = ds.get_split(split)
            torch.cuda.synchronize()
            seconds[split] = time.perf_counter() - t0
            views[split] = len(cams)
            images[split] = imgs
    fills = [(o[1].tile_fill, o[1].pair_fill) for o in rast.outputs]
    t0 = time.perf_counter()
    cpu = dataclasses.replace(parser, device="cpu", num_val_views=1).parse(path, "val")
    cpu_s = time.perf_counter() - t0
    got, want = images["val"][0], cpu.images[0]
    off = np.abs(got - want).max(-1) > 1e-3
    summary = {
        "layout": layout, "faces": int(meta["mesh"].num_faces), "views": views,
        "parse_seconds": seconds,
        "seconds_per_view": sum(seconds.values()) / sum(views.values()),
        "tile_fill": [f[0] for f in fills], "pair_fill": [f[1] for f in fills],
        "tile_capacity": TILE_CAPACITY,
        "alpha_mean": {k: float(v[..., 3].mean()) for k, v in images.items()},
        "card_vs_cpu": {"share_off_1e-3": float(off.mean()),
                        "max_abs_err": float(np.abs(got - want).max()),
                        "mean_abs_err": float(np.abs(got - want).mean()), "cpu_seconds": cpu_s,
                        "tol_share": c["card_vs_cpu_px_share"]},
    }
    ok = (layout == "MeshPBRDataparser" and len(fills) == sum(views.values())
          and all(f[0] <= 1 and f[1] <= 1 for f in fills)
          and all(np.isfinite(v).all() and (v[..., 3].reshape(len(v), -1).max(-1) > 0).all()
                  for v in images.values())
          and summary["card_vs_cpu"]["share_off_1e-3"] <= c["card_vs_cpu_px_share"])
    if not ok:
        raise AssertionError(f"the MeshPBR layout failed a check: {summary}")
    summary["dataset"] = ds
    return summary


def captures_geometry(device, seed, ds) -> dict:
    """(e) of phase 12: dpsr_solve and psr_to_mesh at 128^3 from 100k
    oriented points of the sphere of radius 0.5; tsdf_fusion at 128^3 of
    the depth of (d)'s train views (the unit sphere); the chamfer distance
    of each mesh to its sphere within CAPTURES' bounds; dpsr_solve at 64^3
    on the card against the CPU (1e-4)."""
    import torch

    from geosplatting_tpu_torch.data.dataparsers.synthetic_meshes import TILE_CAPACITY
    from geosplatting_tpu_torch.graphics import dpsr, gmath, mesh_ops, shaders
    from geosplatting_tpu_torch.ops.chamfer import chamfer_distance

    c = CAPTURES
    g = torch.Generator(device=device).manual_seed(seed + 13)
    d = gmath.safe_normalize(torch.randn((c["geometry_points"], 3), generator=g, device=device))
    pts = 0.5 * d * 0.5 + 0.5              # [-1, 1]^3 mapped to the unit cube
    res = c["geometry_resolution"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def surface(mesh):
        return mesh.vertices[mesh.face_mask.repeat_interleave(3)]

    chi, dpsr_s = timed(lambda: dpsr.dpsr_solve(pts, d, resolution=res))
    psr, psr_s = timed(lambda: dpsr.psr_to_mesh(pts, d, resolution=res))
    ref = gmath.safe_normalize(torch.randn((50_000, 3), generator=g, device=device))
    psr_cd = float(chamfer_distance(surface(psr), 0.5 * ref))
    cams, _, meta = ds.get_split("train")
    depths, depth_s = timed(lambda: torch.stack([
        shaders.render_depth(meta["mesh"], cams[i], tile_capacity=TILE_CAPACITY)
        for i in range(len(cams))]))
    tsdf, tsdf_s = timed(lambda: mesh_ops.tsdf_fusion(depths, cams, resolution=res, scale=1.2))
    tsdf_cd = float(chamfer_distance(surface(tsdf), ref))
    small = c["check_resolution"]
    chi_card = dpsr.dpsr_solve(pts[:20_000], d[:20_000], resolution=small)
    chi_cpu = dpsr.dpsr_solve(pts[:20_000].cpu(), d[:20_000].cpu(), resolution=small)
    card_err = float((chi_card.cpu() - chi_cpu).abs().max())
    summary = {
        "points": c["geometry_points"], "resolution": res,
        "dpsr_seconds": dpsr_s, "psr_to_mesh_seconds": psr_s,
        "psr_faces": int(psr.face_mask.sum()), "psr_chamfer": psr_cd,
        "psr_mean_radius": float(surface(psr).norm(dim=-1).mean()),
        "depth_views": len(cams), "depth_seconds": depth_s, "tsdf_seconds": tsdf_s,
        "tsdf_faces": int(tsdf.face_mask.sum()), "tsdf_chamfer": tsdf_cd,
        "chi_finite": bool(torch.isfinite(chi).all()),
        "dpsr_card_vs_cpu": {"resolution": small, "max_abs_err": card_err, "tol": 1e-4},
        "bounds": {"psr_chamfer": c["dpsr_chamfer"], "tsdf_chamfer": c["tsdf_chamfer"]},
    }
    if not (summary["chi_finite"] and psr_cd <= c["dpsr_chamfer"]
            and tsdf_cd <= c["tsdf_chamfer"] and card_err <= 1e-4
            and summary["psr_faces"] > 1000 and summary["tsdf_faces"] > 1000):
        raise AssertionError(f"the geometry tools failed a check: {summary}")
    return summary


def captures(device, seed, kernels, tmp: Path, card: str) -> tuple[dict, dict]:
    """Phase 12: (a) the prior on the COLMAP scene, (b) stage 1 on
    Stanford-ORB, (c) stage 1 on the masked-IDR scene with its silhouette
    check, (d) the MeshPBR layout, (e) the geometry tools. Returns (each
    part's summary and seconds, (a)'s last camera's kernel inputs)."""
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["prior"], captured = captures_prior(device, seed, kernels, tmp)
    phase("captures_prior", **out["prior"], card=card)
    seconds["prior"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    orb = write_orb_scene(tmp / "orb", device)
    write_s = time.perf_counter() - t0
    out["orb"], _ = captures_stage1(device, seed, kernels, orb, "orb",
                                    CAPTURES["orb_pairs_budget"])
    out["orb"]["scene_seconds"] = write_s
    phase("captures_orb", **out["orb"])
    seconds["orb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_dtu_scene(tmp / "dtu", device)
    out["dtu"], renders = captures_stage1(device, seed, kernels, tmp / "dtu", "dtu",
                                          SLICE["pairs_budget"])
    out["dtu"]["silhouettes"] = silhouette_check(device, tmp / "dtu", renders[-1])
    phase("captures_dtu", **out["dtu"])
    seconds["dtu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pbr = captures_pbr(device, tmp)
    ds = pbr.pop("dataset")
    out["pbr"] = pbr
    phase("captures_meshpbr", **pbr)
    seconds["pbr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["geometry"] = captures_geometry(device, seed, ds)
    phase("captures_geometry", **out["geometry"])
    seconds["geometry"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out, captured


# phase 13: the quality benchmark at the JAX package's tiny shape
# (tests/test_quality.py:45-50) and its floors (:52-58)
QUALITY = dict(img_res=32, grid_res=10, n_train=10, n_test=2, batch=2, s1_steps=40,
               s2_steps=12, s3_steps=8, gt_spp_x=6, train_spp_x=2, light_resolution=32)
QUALITY_FLOORS = {"nvs_psnr": (">", 14.0), "relight_psnr": (">", 12.0),
                  "albedo_psnr": (">", 15.0), "roughness_mse": ("<", 0.5),
                  "s1_train_psnr": (">", 14.0)}
TURNTABLE = dict(steps=2, vis_export_every=1)


def quality_chain(device, seed, kernels) -> tuple[dict, dict]:
    """(a) of phase 13: run_quality_chain at the tiny shape on the card, each
    trainer step's launches, fills and gradients gated; the JAX floors.
    Returns (summary, the kernel inputs of stage 2's last camera and of
    stage 3's last G-buffer camera (C = 14))."""
    from geosplatting_tpu_torch.bench.quality_chain import run_quality_chain
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
        GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
    )
    from geosplatting_tpu_torch.train.geosplat_mc_trainer import GeoSplatMCTrainer
    from geosplatting_tpu_torch.train.geosplat_trainer import GeoSplatTrainer

    # the stage that runs: on_stage names each stage as it ends (the
    # evaluation's renders after stage 3 take no backward)
    order = ["s1", "s2", "s3", "eval"]
    running = [order[0]]

    def in_stage(name, keep=lambda a: True):
        return lambda a: running[0] == name and keep(a)

    kernels.reset_launches()
    t0 = time.perf_counter()
    with Launches(GeoSplatTrainer, "train_step", kernels) as s1, \
            Launches(GeoSplatMCTrainer, "train_step", kernels) as s2, \
            Launches(GeoSplatDeferTrainer, "train_step", kernels) as s3, \
            Recorder(rp, "composite_bwd", in_stage("s2")) as bwd2, \
            Recorder(sr, "cumsum_rows", in_stage("s2")) as k3_2, \
            Recorder(rp, "composite_bwd", in_stage("s3", lambda a: a[3] == 14)) as bwd3, \
            Recorder(sr, "cumsum_rows",
                     in_stage("s3", lambda a: a[0].shape[1] == 7 + 14)) as k3_3:
        r = run_quality_chain(
            **QUALITY, seed=seed, device=device,
            on_stage=lambda name, _: running.__setitem__(0, order[order.index(name) + 1]))
    seconds = time.perf_counter() - t0
    captured = {"s2": {"bwd": bwd2.args, "k3": k3_2.args},
                "s3": {"bwd": bwd3.args, "k3": k3_3.args}}
    # rasterizations a camera: stage 3 adds the maps of its edge-aware
    # regularisers (kd; normal where its weight is not 0) to the G-buffer
    c3 = GeoSplatDeferTrainerConfig()
    renders = {"s1": 1, "s2": 1, "s3": 1 + (c3.kd_reg > 0) + (c3.normal_reg > 0)}
    stages = {}
    for name, steps in (("s1", s1), ("s2", s2), ("s3", s3)):
        b = QUALITY["batch"] * renders[name]
        per_step = [{k: float(v) for k, v in m.items()
                     if k in ("loss", "splat_psnr", "nonfinite_grads") or k.endswith("_fill")}
                    for m in steps.outputs]
        stages[name] = {
            "steps": len(per_step), "median_step_s": sorted(steps.seconds)[len(steps.seconds) // 2],
            "max_fill": {k: max(m[k] for m in per_step) for k in per_step[0] if k.endswith("_fill")},
            "finite": all(math.isfinite(m["loss"]) and math.isfinite(m["splat_psnr"])
                          for m in per_step),
            "nonfinite_grads": sum(m["nonfinite_grads"] for m in per_step),
            "once_per_camera": all(all(n[k] == b for k in kernels.RASTER_KERNELS[:4])
                                   and all(n[k] >= b for k in kernels.RASTER_KERNELS[4:])
                                   for n in steps.launches),
            "launches": steps.totals(), "launches_per_step": b,
        }
    floors = {k: bool(r[k] > v if op == ">" else r[k] < v)
              for k, (op, v) in QUALITY_FLOORS.items()}
    return {"config": QUALITY, "result": r, "stages": stages, "floors": floors,
            "seconds": seconds}, captured


def turntable_task(device, seed, kernels, scene: Path) -> dict:
    """(b) of phase 13: the product phase's GeoSplatTrainTask with
    turntable="+z" and vis_export_every: its frames and HTML snapshots."""
    import base64

    import numpy as np
    from PIL import Image

    from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask
    from geosplatting_tpu_torch.visualization.turntable import OptimizationVisualizer

    c = TURNTABLE
    task = GeoSplatTrainTask(
        dataset_path=scene, experiment_name="turntable", seed=seed, num_steps=c["steps"],
        batch_size=SLICE["cameras"], num_steps_per_save=c["steps"],
        num_steps_per_val=c["steps"], num_val_images=2, resolution=SLICE["grid"],
        light_resolution=512, scene_scale=0.8, pairs_budget=SLICE["pairs_budget"],
        device=str(device), sdf_sphere_init=PRODUCT["sdf_sphere_init"], turntable="+z",
        vis_export_every=c["vis_export_every"],
    )
    t0 = time.perf_counter()
    with Timed(GeoSplatTrainTask, "vis_splats") as snap:
        run_dir = Path(task.run()["output_dir"]).resolve()
    seconds = time.perf_counter() - t0
    frames = sorted((run_dir / "dump" / "vis").glob("*.png"))
    htmls = sorted((run_dir / "vis_html").glob("*.html"))
    schedule = OptimizationVisualizer(up="+z", device=str(device))
    schedule.setup(c["steps"])
    shapes = [list(np.asarray(Image.open(p)).shape) for p in frames]
    splats = [len(base64.b64decode(re.search(r'const B64 = "([^"]*)"', p.read_text()).group(1)))
              // 32 for p in htmls]
    out = {"frames": [p.name for p in frames], "frame_shapes": shapes,
           "frame_bytes": [p.stat().st_size for p in frames],
           "schedule": sorted(schedule._sequence), "html": [p.name for p in htmls],
           "html_bytes": [p.stat().st_size for p in htmls], "html_splats": splats,
           "snapshot_seconds": snap.seconds, "seconds": seconds}
    want_html = [f"{s:06d}.html" for s in range(1, c["steps"] + 1)
                 if s % c["vis_export_every"] == 0]
    if not ([int(p.stem) for p in frames] == out["schedule"] and frames
            and all(sh[:2] == [800, 800] and sh[2] in (3, 4) for sh in shapes)
            and all(b > 0 for b in out["frame_bytes"]) and out["html"] == want_html
            and all(n > 0 for n in splats)):
        raise AssertionError(f"the turntable task failed a check: {out}")
    return out


def quality(device, seed, kernels, scene: Path, card: str) -> tuple[dict, dict]:
    """Phase 13: (a) the quality chain and its floors, (b) the turntable
    task. Returns (summary, the chain's kernel inputs from
    ``quality_chain``); raises on any failed check."""
    out = {}
    out["chain"], captured = quality_chain(device, seed, kernels)
    r, stages = out["chain"]["result"], out["chain"]["stages"]
    phase("quality", **out["chain"], card=card)
    out["turntable"] = turntable_task(device, seed, kernels, scene)
    phase("quality_turntable", **out["turntable"])
    if not (all(out["chain"]["floors"].values())
            and all(st["finite"] and st["nonfinite_grads"] == 0 and st["once_per_camera"]
                    and st["max_fill"] and max(st["max_fill"].values()) <= 1.0
                    and all(n > 0 for n in st["launches"].values())
                    for st in stages.values())
            and {"pair_fill", "face_fill"} <= set(stages["s1"]["max_fill"])
            and {"pair_fill", "mesh_tile_fill", "mesh_pair_fill"} <= set(stages["s3"]["max_fill"])
            and all(math.isfinite(r[k]) for k in QUALITY_FLOORS)):
        raise AssertionError(f"the quality phase failed a check: {out['chain']}")
    return out, captured


# phase 14: the camera-batched rasterizer (GeoSplatter / GeoSplatterMC /
# GeoSplatterDefer batched_binning, GSplatter camera_batching="vmap") against
# the per-camera path, with the tolerances the JAX package holds its own two
# paths to (tests/test_geosplat_stage1.py:129-145, tests/test_batched_binning.py)
BATCHED = dict(compare_step=200, timed_steps=(200, 201), stage23_cameras=2,
               stage23_image=800,
               tol={"stage1": {"rgba": (1e-5, 1e-5), "grad": (2e-4, 2e-3)},
                    "gsplat": {"rgba": (1e-5, 1e-5), "grad": (2e-4, 2e-3)},
                    "stage2": {"rgba": (5e-4, 1e-3), "grad": (1e-3, 5e-3)},
                    "stage3": {"rgba": (5e-4, 1e-3), "grad": (1e-2, 5e-3)}},
               antialias_atol=2e-4, antialias_grad_rel=1e-3, antialias_sphere=(120, 112),
               resize_atol=1e-5, shade_points=4096, gsplat2d_timed_steps=2)


@contextlib.contextmanager
def deterministic(record: list):
    """PyTorch's deterministic algorithms for the with-block (index_add_
    without float atomics, cuBLAS on the fixed workspace main() sets), so
    that two runs of one path give the same bits and one path can be held
    to another: with the default algorithms two runs of stage 2's per-camera
    path differ by as much as the tolerances (phase 14 (c) reports by how
    much). Ops without a deterministic version warn; their messages go to
    ``record``."""
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        record.extend(sorted({str(w.message)[:160] for w in caught
                              if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)


def close_to(got, want, atol: float, rtol: float) -> dict:
    """The largest |got - want|, the entries past atol + rtol |want|, and
    whether got is finite with none past it."""
    import torch

    err = (got.double() - want.double()).abs()
    bad = int((err > atol + rtol * want.double().abs()).sum())
    return {"max_abs_err": float(err.max()), "past_tol": bad,
            "ok": bad == 0 and bool(torch.isfinite(got).all())}


class PairLists:
    """Collects the PairBins of every composite (forward) the rasterizer
    runs inside the with-block."""

    def __enter__(self):
        from geosplatting_tpu_torch.ops import rasterize as rz

        self.rz, self.fn, self.bins = rz, rz.composite_pairs, []

        def spy(bins, *args):
            self.bins.append(bins)
            return self.fn(bins, *args)

        rz.composite_pairs = spy
        return self

    def __exit__(self, *exc):
        self.rz.composite_pairs = self.fn


def same_pair_lists(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) > 0 and all(
        torch.equal(x.sorted_gid, y.sorted_gid) and torch.equal(x.seg_start, y.seg_start)
        and torch.equal(x.total_pairs, y.total_pairs) for x, y in zip(a, b))


def flat_grads(module):
    import torch

    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in module.parameters()])


def binning_bytes(rz, step) -> dict:
    """The device memory the binning alone takes above what it is given:
    the arguments of the last ``bin_pairs_batched`` call of ``step()``,
    binned again as one batch and as its first camera alone."""
    import torch

    fn, calls = rz.bin_pairs_batched, []

    def keep(*args, **kw):
        calls[:] = [(args, kw)]
        return fn(*args, **kw)

    rz.bin_pairs_batched = keep
    try:
        step()
    finally:
        rz.bin_pairs_batched = fn
    (proj_b, *rest), kw = calls[0]
    proj_b = type(proj_b)(*(x.detach() for x in proj_b))
    out = {}
    one_camera = type(proj_b)(*(x[:1] for x in proj_b))
    for name, proj in (("batch", proj_b), ("one_camera", one_camera)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            bins = fn(proj, *rest, **kw)
        torch.cuda.synchronize()
        out[name] = torch.cuda.max_memory_allocated() - base
        del bins
    out["cameras"] = int(proj_b.means2d.shape[0])
    out["max_pairs"] = int(kw["max_pairs"])
    return out


def batched_slice(device, seed, kernels) -> tuple[dict, dict]:
    """(a) of phase 14: the slice with batched_binning against the map path
    from the same state, jitter draw and background, then 2 timed steps.
    Returns (summary, the last camera's kernel inputs)."""
    import torch

    from geosplatting_tpu_torch.models.geosplat import GeoSplatter
    from geosplatting_tpu_torch.ops import rasterize as rz
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr

    batch = SLICE["cameras"]
    tol = BATCHED["tol"]["stage1"]
    runs, timing, nondeterministic = {}, {}, []
    for batched in (False, True):
        gen = torch.Generator(device=device).manual_seed(seed)
        trainer, cams, gt = make_slice(device, gen, **SLICE, batched_binning=batched)
        model = trainer.model
        with torch.no_grad():
            mesh, _, _ = model.get_geometry()
        draw = torch.Generator(device=device).manual_seed(seed + 1)
        noise = torch.randn((model.num_field_points(mesh), 3), generator=draw, device=device)
        background = torch.rand(gt[..., :3].shape, generator=draw, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic(nondeterministic), PairLists() as lists, \
                Timed(GeoSplatter, "render") as render:
            (loss, _, reg), aux = trainer.compute_grads(
                cams, gt, float(BATCHED["compare_step"]), sampling="face",
                background=background, jitter_noise=noise)
        runs[batched] = {"bins": lists.bins, "rgba": render.outputs[0][0].detach(),
                         "loss": loss + reg, "grads": flat_grads(model),
                         "seconds": time.perf_counter() - t0}
        if not batched:
            del trainer, model
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        totals, seconds = {k: 0 for k in kernels.RASTER_KERNELS}, []
        recorders = [Recorder(rp, "composite_bwd"), Recorder(sr, "cumsum_rows")]
        steps = BATCHED["timed_steps"]
        for i, step in enumerate(steps):
            if i == len(steps) - 1:
                for r in recorders:
                    r.__enter__()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            m = trainer.train_step(cams, gt, float(step), sampling="face", generator=gen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
            metrics = {k: float(v) for k, v in m.items()}
            if not (math.isfinite(metrics["loss"]) and metrics["nonfinite_grads"] == 0
                    and metrics["pair_fill"] <= 1.0):
                raise AssertionError(f"batched slice step {step}: {metrics}")
            if not (all(counts[k] == batch for k in kernels.RASTER_KERNELS[:4])
                    and counts["k3_cumsum_rows"] >= batch):
                raise AssertionError(f"batched slice step {step}: launches {counts}")
            for k in totals:
                totals[k] += counts[k]
        for r in recorders:
            r.__exit__()
        timing = {"step_seconds": seconds, "median_step_s": sorted(seconds)[len(seconds) // 2],
                  "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "launches": totals, "last_metrics": metrics,
                  "binning_peak_bytes": binning_bytes(rz, lambda: trainer.compute_grads(
                      cams, gt, float(steps[-1]), sampling="face", generator=gen))}
        captured = {"bwd": recorders[0].args, "k3": recorders[1].args}
    m0, m1 = runs[False], runs[True]
    checks = {
        "pair_lists_equal": same_pair_lists(m0["bins"], m1["bins"]),
        "cameras_binned": [len(m0["bins"]), len(m1["bins"])],
        "total_pairs": [int(b.total_pairs) for b in m1["bins"]],
        "rgba": close_to(m1["rgba"], m0["rgba"], *tol["rgba"]),
        "loss": close_to(m1["loss"], m0["loss"], *tol["grad"]),
        "grads": close_to(m1["grads"], m0["grads"], *tol["grad"]),
        "compare_seconds": {"map": m0["seconds"], "batched": m1["seconds"]},
        "nondeterministic_ops": nondeterministic,
    }
    summary = {"checks": checks, **timing, "steps": len(BATCHED["timed_steps"]),
               "cameras": batch, "binning_slots": batch * m1["bins"][0].sorted_gid.shape[0]}
    if not (checks["pair_lists_equal"] and len(m1["bins"]) == batch and checks["rgba"]["ok"]
            and checks["loss"]["ok"] and checks["grads"]["ok"]):
        raise AssertionError(f"batched binning disagrees with the map path: {checks}")
    return summary, captured


def batched_gsplat(device, seed, kernels) -> dict:
    """(b) of phase 14: bench.py's 3DGS workload with camera_batching="vmap"
    against "map" (the images, one step's xys_grad_norm and vis_counts),
    then 4 warm-up and 10 timed vmap steps."""
    import torch

    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    c = GSPLAT
    b = c["cameras"]
    tol = BATCHED["tol"]["gsplat"]
    out, nondeterministic = {}, []
    for batching in ("map", "vmap"):
        gen = torch.Generator(device=device).manual_seed(seed)
        splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=0,
                                               camera_batching=batching)
        trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=b, warmup_length=10**9), model,
                                dataset_size=b)
        trainer.init_state(splats)
        with deterministic(nondeterministic):
            with torch.no_grad():
                if batching == "vmap":
                    rgba = model.render_rgba_batched(trainer.splats(), cams)[0]
                else:
                    rgba = torch.stack([model.render_rgba(trainer.splats(), cams[i])[0]
                                        for i in range(b)])
            m = trainer.train_step(cams, gt, max_sh_degree=None, generator=gen)
        out[batching] = {"rgba": rgba, "xys_grad_norm": trainer.xys_grad_norm.clone(),
                         "vis_counts": trainer.vis_counts.clone(), "loss": m["loss"]}
    seconds, totals = [], {k: 0 for k in kernels.RASTER_KERNELS}
    for i in range(c["warmup_steps"] + c["timed_steps"]):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(cams, gt, max_sh_degree=None, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: kernels.launches[k] for k in kernels.RASTER_KERNELS}
        if not (math.isfinite(float(m["loss"])) and float(m["nonfinite_grads"]) == 0
                and float(m["pair_fill"]) <= 1.0 and all(counts[k] == b for k in counts)):
            raise AssertionError(f"vmap 3DGS step {i}: {m} {counts}")
        if i >= c["warmup_steps"]:
            seconds.append(dt)
            for k in totals:
                totals[k] += counts[k]
    a, v = out["map"], out["vmap"]
    checks = {"rgba": close_to(v["rgba"], a["rgba"], *tol["rgba"]),
              "xys_grad_norm": close_to(v["xys_grad_norm"], a["xys_grad_norm"], *tol["grad"]),
              "vis_counts_equal": bool(torch.equal(v["vis_counts"], a["vis_counts"])),
              "visible": float(v["vis_counts"].sum()),
              "loss": close_to(v["loss"], a["loss"], *tol["grad"]),
              "nondeterministic_ops": nondeterministic}
    summary = {"checks": checks, "timed_step_seconds": seconds,
               "median_step_s": sorted(seconds)[len(seconds) // 2], "launches": totals}
    if not (checks["rgba"]["ok"] and checks["xys_grad_norm"]["ok"] and checks["loss"]["ok"]
            and checks["vis_counts_equal"] and checks["visible"] > 0):
        raise AssertionError(f"camera_batching='vmap' disagrees with 'map': {checks}")
    return summary


def map_vs_batched(model, render, tol) -> dict:
    """One render and backward of sum(rgba) + reg with ``model``'s binning
    per camera, then batched, from the same weights and draws, under
    deterministic algorithms."""
    import torch

    runs, nondeterministic = {}, []
    for batched in (False, True):
        model.batched_binning = batched
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic(nondeterministic), PairLists() as lists:
            rgba, reg, aux = render()
            (rgba.sum() + reg).backward()
        torch.cuda.synchronize()
        runs[batched] = {"rgba": rgba.detach(), "grads": flat_grads(model),
                         "bins": lists.bins, "total_pairs": int(aux["total_pairs"]),
                         "seconds": time.perf_counter() - t0}
    model.zero_grad(set_to_none=True)
    m0, m1 = runs[False], runs[True]
    out = {"pair_lists_equal": same_pair_lists(m0["bins"], m1["bins"]),
           "total_pairs": [m0["total_pairs"], m1["total_pairs"]],
           "rgba": close_to(m1["rgba"], m0["rgba"], *tol["rgba"]),
           "grads": close_to(m1["grads"], m0["grads"], *tol["grad"]),
           "seconds": {"map": m0["seconds"], "batched": m1["seconds"]},
           "nondeterministic_ops": nondeterministic}
    return out


def batched_stages(device, seed, product_run: Path, stage2_run: Path) -> dict:
    """(c) of phase 14: one render and backward of 2 cameras at 800x800 per
    camera and batched, stage 2 at the stage2 phase's widths (from the
    product run's stage-1 export) and stage 3 at the chain's (from its
    stage-2 run); stage 2 once more with tone_type="aces"."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.engine.stage_io import find_export, load_export
    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
    from geosplatting_tpu_torch.scripts import train_geosplat_defer as cli3

    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                              num_samples=BATCHED["stage23_cameras"],
                              width=BATCHED["stage23_image"], height=BATCHED["stage23_image"],
                              device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    export = load_export(find_export(product_run))
    planes = np.shape(export["ks_enc"]["planes"])
    m2 = GeoSplatterMC(resolution=STAGE2["grid"], scale=STAGE2["scene_scale"],
                       num_samples_x=STAGE2["num_samples_x"], shadow_steps=STAGE2["shadow_steps"],
                       pairs_budget=STAGE2["pairs_budget"],
                       max_render_faces=STAGE2["max_render_faces"],
                       triplane_resolution=planes[1], triplane_components=planes[-1],
                       generator=gen, device=device)
    m2.init_from_stage1(export)
    noise = torch.randn(m2.field.jitter_shape(m2.num_field_points()), generator=gen,
                        device=device)
    draws = [m2.draw_shade(gen) for _ in range(len(cams))]
    s2 = map_vs_batched(m2, lambda: m2.render(cams, jitter_noise=noise, draws=draws),
                        BATCHED["tol"]["stage2"])
    with torch.no_grad():
        aces, _, _ = m2.render(cams, tone_type="aces", jitter_noise=noise, draws=draws)
    s2["aces"] = {"finite": bool(torch.isfinite(aces).all()), "min": float(aces.min()),
                  "max": float(aces.max())}
    del m2, draws, aces

    task3 = dataclasses.replace(cli3.TASKS["s4r-twosphere"], load=stage2_run)
    export3 = load_export(find_export(stage2_run))
    m3 = task3.make_model(export3, device)
    m3.init_from_stage2(export3)
    draws3 = [m3.draw_shade(cams, gen) for _ in range(len(cams))]
    s3 = map_vs_batched(m3, lambda: m3.render(cams, draws=draws3), BATCHED["tol"]["stage3"])
    del draws3, m3
    summary = {"stage2": s2, "stage3": s3, "cameras": len(cams),
               "image": [BATCHED["stage23_image"]] * 2,
               "stage2_widths": {k: STAGE2[k] for k in ("grid", "scene_scale", "pairs_budget",
                                                        "max_render_faces", "num_samples_x")},
               "stage3_widths": {k: getattr(task3, k) for k in (
                   "resolution", "scene_scale", "pairs_budget", "num_samples_x")}}
    if not (all(s["pair_lists_equal"] and s["rgba"]["ok"] and s["grads"]["ok"]
                and s["total_pairs"][0] == s["total_pairs"][1] > 0 for s in (s2, s3))
            and s2["aces"]["finite"] and 0.0 <= s2["aces"]["min"] <= s2["aces"]["max"] <= 1.0):
        raise AssertionError(f"batched binning disagrees with the map path: {summary}")
    return summary


def antialias_card_vs_cpu(device, g) -> dict:
    """Antialias at 800x800 on a fixed mesh, the 120 x 112 UV sphere of
    phase 10 (c) (the same in every run, where a trained mesh is not), on
    the card against the CPU from the same inputs. The value is held in
    float32, as the port runs it, to 2e-4 over every pixel: the projected
    vertices round differently on the two devices (by an ulp, 6e-5 px at
    800), and an ulp moves a blend weight by as much. The vertex gradient is
    held to 1e-3 of its largest entry in float64. In float32 a pair whose
    edge crosses exactly at its midpoint on one device (weight 0: neither
    pixel blends, and the pair passes no gradient) may cross an ulp off it
    on the other (a weight near 0 that passes the whole gradient of the
    crossing): the value agrees, the gradient of such a pair does not, and
    on this mesh that puts the two devices' float32 gradients more than
    1e-3 apart in every run. The float32 gradient's error is reported
    beside the gate. The cotangent is drawn from the CPU generator ``g``."""
    import dataclasses

    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras
    from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
    from geosplatting_tpu_torch.ops.mesh_raster import (
        RasterOut, antialias, interpolate, rasterize_mesh,
    )

    res = BATCHED["stage23_image"]
    cam = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                             num_samples=1, width=res, height=res, device=device)[0]
    mesh = uv_sphere(*BATCHED["antialias_sphere"], device=device)
    faces = int(mesh.indices.shape[0])
    with torch.no_grad():
        rast, info = rasterize_mesh(mesh, cam, tile_capacity=faces)
        vcol = torch.clamp(mesh.vertices * 0.8 + 0.5, 0.0, 1.0)
        color = interpolate(vcol, mesh, rast) + (rast.tri_id < 0)[..., None] * 0.1
    w = torch.randn(color.shape, generator=g)

    def run(dev, dtype):
        v = mesh.vertices.detach().to(dev, dtype).requires_grad_()
        m = TriangleMesh(vertices=v, indices=mesh.indices.to(dev))
        c = dataclasses.replace(cam, **{k: getattr(cam, k).to(dev, dtype)
                                        for k in ("c2w", "fx", "fy", "cx", "cy")})
        out = antialias(color.to(dev, dtype), m, c, RasterOut(*(x.to(dev) for x in rast)))
        (out * w.to(dev, dtype)).sum().backward()
        return out.detach().cpu().double(), v.grad.cpu().double()

    (a_card, g_card), (a_cpu, g_cpu) = run(device, torch.float32), run("cpu", torch.float32)
    (a64_card, g64_card), (a64_cpu, g64_cpu) = run(device, torch.float64), run("cpu", torch.float64)
    grad_max = float(g64_cpu.abs().max())
    aa = {"mesh": f"uv_sphere{tuple(BATCHED['antialias_sphere'])}", "faces": faces,
          "tile_fill": info.tile_fill,
          "blended_pixels": int(((a_cpu - color.cpu()).abs().amax(-1) > 1e-3).sum()),
          "max_abs_err": float((a_card - a_cpu).abs().max()),
          "float64_max_abs_err": float((a64_card - a64_cpu).abs().max()),
          "grad_max_abs_err": float((g64_card - g64_cpu).abs().max()), "grad_max": grad_max,
          "float32_grad_max_abs_err": float((g_card - g_cpu).abs().max()),
          "float32_grad_max": float(g_cpu.abs().max())}
    aa["grad_rel_err"] = aa["grad_max_abs_err"] / max(grad_max, 1e-30)
    aa["float32_grad_rel_err"] = aa["float32_grad_max_abs_err"] / max(aa["float32_grad_max"],
                                                                        1e-30)
    aa["ok"] = (aa["max_abs_err"] <= BATCHED["antialias_atol"]
                and aa["float64_max_abs_err"] <= BATCHED["antialias_atol"]
                and aa["blended_pixels"] > 0 and grad_max > 0
                and aa["grad_rel_err"] <= BATCHED["antialias_grad_rel"])
    return aa


def resize_card_vs_cpu(device, seed) -> dict:
    """images.resize with every method jax.image.resize takes, 800 -> 512
    and 512 -> 800, on the card against the CPU: within 1e-5 absolute
    ("nearest" equal)."""
    import torch

    from geosplatting_tpu_torch.graphics import images

    g = torch.Generator().manual_seed(seed + 1)
    out = {}
    for src, dst in ((800, 512), (512, 800)):
        img = torch.rand((src, src, 3), generator=g)
        for method in ("nearest", *images.RESIZE_KERNELS):
            got = images.resize(img.to(device), dst, dst, method).cpu()
            want = images.resize(img, dst, dst, method)
            err = float((got - want).abs().max())
            out[f"{method}_{src}_{dst}"] = {
                "max_abs_err": err, "shape": list(got.shape),
                "ok": got.shape == (dst, dst, 3) and (
                    err == 0.0 if method == "nearest" else err <= BATCHED["resize_atol"])}
    return out


def batched_options_card_vs_cpu(device, seed) -> dict:
    """(e) of phase 14: antialias on a fixed mesh (``antialias_card_vs_cpu``),
    images.resize's methods (``resize_card_vs_cpu``) and env_shade with
    bsdf="diffuse" / "white", on the card against the CPU from the same
    inputs."""
    import torch

    from geosplatting_tpu_torch.ops import envshade as es

    g = torch.Generator().manual_seed(seed)
    aa = antialias_card_vs_cpu(device, g)
    resized = resize_card_vs_cpu(device, seed)

    # env_shade's white lobe (no visibility: the residual is 0 as the
    # specular is): the rule of the card-vs-CPU tests (< 3 % of entries past
    # 5e-3 + 5e-3 |x|, cosine > 0.999; a texel lookup may flip)
    num = BATCHED["shade_points"]
    d = torch.nn.functional.normalize(torch.randn((num, 3), generator=g), dim=-1)
    pos = d * (0.36 + 0.2 * torch.rand((num, 1), generator=g))
    view = torch.tensor([0.3, 0.6, 2.8])
    nrm = torch.nn.functional.normalize(
        0.3 * d + torch.nn.functional.normalize(view - pos, dim=-1), dim=-1)
    kd = 0.2 + 0.6 * torch.rand((num, 3), generator=g)
    arm = torch.stack((torch.zeros(num), 0.3 + 0.6 * torch.rand(num, generator=g),
                       0.05 + 0.75 * torch.rand(num, generator=g)), -1)
    i, j = torch.meshgrid(torch.arange(32.0), torch.arange(64.0), indexing="ij")
    light = (0.3 + 0.2 * torch.sin(i / 10) * torch.cos(j / 9))[..., None] + torch.tensor(
        [0.0, 0.07, 0.14])
    draws = es.draw_shade(num, num_samples_x=4, generator=g)
    shade = {}
    for bsdf in ("diffuse", "white"):
        res = [es.env_shade(*(x.to(dev) for x in (pos, nrm, view, kd, arm)),
                            es.compute_light_pdf(light.to(dev)), draws.to(dev), bsdf=bsdf)
               for dev in (device, "cpu")]
        checks = []
        for got, want in zip(*res):
            got, want = got.double().cpu(), want.double()
            off = float(((got - want).abs() > 5e-3 + 5e-3 * want.abs()).float().mean())
            cos = float((got * want).sum() / max(float(got.norm() * want.norm()), 1e-300))
            checks.append({"share_off": off, "cosine": cos,
                           "max_abs_err": float((got - want).abs().max())})
        spec_zero = float(res[0][1].abs().max()) == 0.0
        shade[bsdf] = {"outputs": checks, "specular_zero": spec_zero,
                       "ok": spec_zero and all(bool(torch.isfinite(o).all()) for o in res[0])
                       and all(c["share_off"] < 0.03 for c in checks)
                       and checks[0]["cosine"] > 0.999}
    summary = {"antialias": aa, "resize": resized, "env_shade": shade}
    if not (aa["ok"] and all(r["ok"] for r in resized.values())
            and all(s["ok"] for s in shade.values())):
        raise AssertionError(f"an option disagrees card vs CPU: {summary}")
    return summary


def batched_gsplat2d(device, seed) -> dict:
    """(f) of phase 14: phase 11 (a)'s 2DGS scene with camera_batching="vmap"
    against "map" from the same state, background and regulariser weights:
    each camera's dense tile table equal exactly (bin_gaussians_batched's
    one sort against bin_gaussians alone), the images, the regularisers'
    maps, one step's loss, gradients, xys_grad_norm and vis_counts within
    the 3DGS comparison's tolerances, both under deterministic algorithms;
    then 1 warm-up and ``gsplat2d_timed_steps`` timed steps of each path,
    alternating (median s/step of each)."""
    import torch

    from geosplatting_tpu_torch.ops import rasterize_2dgs as r2d
    from geosplatting_tpu_torch.train.gsplat_trainer import GSplatTrainer, GSplatTrainerConfig

    c, c2 = GSPLAT, GSPLAT2D
    b = c["cameras"]
    tol = BATCHED["tol"]["gsplat"]
    maps = ("normal", "pseudo_normal", "distort", "median_depth", "depth")
    runs, trainers, nondeterministic = {}, {}, []
    for batching in ("map", "vmap"):
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=0, rasterize_mode="2dgs",
                                               pairs_per_gaussian=c2["pairs_per_gaussian"],
                                               tile_capacity=c2["tile_capacity"],
                                               camera_batching=batching)
        trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=b, warmup_length=10**9), model,
                                dataset_size=b)
        trainer.init_state(splats)
        reg = (trainer.config.normal_weight, trainer.config.distort_weight)
        with deterministic(nondeterministic):
            with torch.no_grad(), Timed(r2d, "bin_gaussians") as one, \
                    Timed(r2d, "bin_gaussians_batched") as batch:
                if batching == "vmap":
                    rgba, info = model.render_rgba_batched(trainer.splats(), cams)
                    tables = list(batch.outputs[0].tile_gid)
                else:
                    per = [model.render_rgba(trainer.splats(), cams[i]) for i in range(b)]
                    rgba = torch.stack([r for r, _ in per])
                    info = {k: torch.stack([i[k] for _, i in per]) for k in maps}
                    tables = [o.tile_gid for o in one.outputs]
                    del per
            m = trainer.train_step(cams, gt, max_sh_degree=None, reg_weights=reg,
                                   generator=gen)
        runs[batching] = {
            "rgba": rgba, "maps": {k: info[k] for k in maps}, "tables": tables,
            "bin_calls": [len(one.outputs), len(batch.outputs)],
            "grads": torch.cat([trainer.params[k].grad.reshape(-1) for k in trainer.specs]),
            "xys_grad_norm": trainer.xys_grad_norm.clone(),
            "vis_counts": trainer.vis_counts.clone(),
            "metrics": {k: float(v) for k, v in m.items()}}
        trainers[batching] = (trainer, cams, gt, gen, reg)
    a, v = runs["map"], runs["vmap"]
    checks = {
        "tables_equal": len(a["tables"]) == len(v["tables"]) == b and all(
            torch.equal(x, y) for x, y in zip(a["tables"], v["tables"])),
        "bin_calls": {"map": a["bin_calls"], "vmap": v["bin_calls"]},
        "rgba": close_to(v["rgba"], a["rgba"], *tol["rgba"]),
        "maps": {k: close_to(v["maps"][k], a["maps"][k], *tol["rgba"]) for k in maps},
        "loss": close_to(torch.tensor(v["metrics"]["loss"]),
                         torch.tensor(a["metrics"]["loss"]), *tol["grad"]),
        "grads": close_to(v["grads"], a["grads"], *tol["grad"]),
        "xys_grad_norm": close_to(v["xys_grad_norm"], a["xys_grad_norm"], *tol["grad"]),
        "vis_counts_equal": bool(torch.equal(v["vis_counts"], a["vis_counts"])),
        "visible": float(v["vis_counts"].sum()),
        "metrics": {"map": a["metrics"], "vmap": v["metrics"]},
        "nondeterministic_ops": nondeterministic}
    del runs, a, v
    seconds = {"map": [], "vmap": []}
    for i in range(1 + BATCHED["gsplat2d_timed_steps"]):
        for batching, (trainer, cams, gt, gen, reg) in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.train_step(cams, gt, max_sh_degree=None, reg_weights=reg,
                                   generator=gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not (math.isfinite(float(m["loss"])) and float(m["nonfinite_grads"]) == 0
                    and float(m["pair_fill"]) <= 1.0 and float(m["tile_fill"]) <= 1.0):
                raise AssertionError(f"2DGS {batching} step {i}: {m}")
            if i >= 1:
                seconds[batching].append(dt)
    summary = {"checks": checks, "timed_step_seconds": seconds,
               "median_step_s": {k: sorted(x)[len(x) // 2] for k, x in seconds.items()}}
    ok = (checks["tables_equal"] and checks["bin_calls"] == {"map": [b, 0], "vmap": [0, 1]}
          and checks["rgba"]["ok"] and all(r["ok"] for r in checks["maps"].values())
          and checks["loss"]["ok"] and checks["grads"]["ok"] and checks["xys_grad_norm"]["ok"]
          and checks["vis_counts_equal"] and checks["visible"] > 0
          and all(x["tile_fill"] <= 1.0 and x["nonfinite_grads"] == 0
                  for x in checks["metrics"].values()))
    if not ok:
        raise AssertionError(f"2DGS camera_batching='vmap' disagrees with 'map': {summary}")
    return summary


def batched(device, seed, kernels, product_run: Path, stage2_run: Path, card: str,
            slice_median: float, gsplat_median: float) -> tuple[dict, dict]:
    """Phase 14 of the docstring, (a)-(c), (e) and (f); returns (the phase's
    numbers, (a)'s last camera's kernel inputs) for (d)."""
    out = {}
    out["slice"], captured = batched_slice(device, seed, kernels)
    phase("batched_slice", **out["slice"], map_median_face_step_s=slice_median, card=card)
    out["gsplat"] = batched_gsplat(device, seed, kernels)
    phase("batched_gsplat", **out["gsplat"], map_median_step_s=gsplat_median, card=card)
    out["stages"] = batched_stages(device, seed, product_run, stage2_run)
    phase("batched_stages", **out["stages"])
    out["options"] = batched_options_card_vs_cpu(device, seed)
    phase("batched_options_card_vs_cpu", **out["options"])
    out["gsplat2d"] = batched_gsplat2d(device, seed)
    phase("batched_gsplat2d", **out["gsplat2d"], card=card)
    return out, captured


# --- phase 15: the root entry scripts and multi-GPU training ----------------------

# (a) the scripts at the quality benchmark's reduced shape (grid 48, batch
# 4; 160^2 images, the S4R layout's 800^2 / 5: its 128^2 does not divide
# 800), a few steps a stage; (b) the premask mesh: two UV spheres at the
# quality scene's centres and radii; (c)-(e) two gloo ranks sharing the one
# card. Tolerances: the JAX package's between its DP and single-device steps
# (tests/test_dp_geosplat.py:98-99, 174, 222), its sharding tests' for the
# images (tests/test_tile_sharding.py:36-37, tests/test_gs_sharding.py:50-52)
# and, for the sharded renders' gradients, the one between its own two
# rasterizer backends (rtol 2e-3, atol 2e-3 of the largest entry past 1;
# tests/test_rasterize_pallas.py:127-132): at these scales a band's segment
# sums differ from the whole image's by more than the sharding test's 2e-4,
# which was set on the dense backend at 64 x 48
SCRIPTS_DP = dict(
    scene=dict(n_train=8, n_test=2, res=160, spp_x=4, seed=11),
    pipeline=dict(resolution=48, batch=4, light_resolution=128, num_samples_x=4,
                  steps=(2, 1, 1)),
    mask=dict(rows=48, cols=64, tile_capacity=8192, iou=0.97),
    world=2, step=200.0, stage23_cameras=2, gs_gaussians=1_008_000, task_steps=2,
    task_triplane=64,   # (e) checks who writes: a small export and checkpoints
    tol={"loss_rtol": 1e-4, "stage1": (1e-3, 2e-5), "gsplat": (1e-3, 2e-5),
         "stage2": (2e-3, 2e-5), "stage3": (2e-3, 2e-5), "tile_fwd": 3e-5, "gs_fwd": 1e-5,
         "render_grad": 2e-3},
)


def scripts_pipeline(device, seed, kernels, tmp: Path) -> dict:
    """(a) of phase 15: make_synthetic_scene, then run_pipeline through the
    three stages and reliteval on it."""
    import torch

    from geosplatting_tpu_torch.scripts import make_synthetic_scene, run_pipeline

    c, p = SCRIPTS_DP["scene"], SCRIPTS_DP["pipeline"]
    t0 = time.perf_counter()
    scene = make_synthetic_scene.make_scene(
        tmp / "synthetic" / "twosphere", n_train=c["n_train"], n_test=c["n_test"], res=c["res"],
        spp_x=c["spp_x"], seed=c["seed"], device=device, log=lambda msg: None)
    scene_s = time.perf_counter() - t0
    s1, s2, s3 = p["steps"]
    args = run_pipeline.parse_args([
        "--scene", "twosphere", "--dataset_path", str(scene), "--resolution", str(p["resolution"]),
        "--scene_scale", "1.0", "--light_resolution", str(p["light_resolution"]),
        "--s1-steps", str(s1), "--s2-steps", str(s2), "--s3-steps", str(s3),
        "--batch", str(p["batch"]), "--scale_factor", str(c["res"] / 800), "--seed", str(seed),
        "--num_samples_x", str(p["num_samples_x"]), "--eval", "reliteval",
        "--device", str(device)])
    cwd = os.getcwd()
    os.chdir(tmp)   # outputs/ under the temporary directory
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run_pipeline.run_pipeline(args)
        torch.cuda.synchronize()
        pipeline_s = time.perf_counter() - t0
        launches = {k: kernels.launches[k] for k in kernels.KERNELS}
        run = (tmp / out["output_dir"]).resolve()
    finally:
        os.chdir(cwd)
    ev = out.pop("eval")
    numbers = [v for k, v in ev.items() if k != "albedo_scaling"]
    flat = [x for v in numbers for x in (v.values() if isinstance(v, dict) else [v])]
    flat = [x for x in flat + ev["albedo_scaling"] if x is not None]   # no LPIPS weights
    fills = {k: v for k, v in out.items() if k.endswith("_fill")}
    summary = {"scene": str(scene), "scene_seconds": scene_s, "pipeline_seconds": pipeline_s,
               **out, "eval": ev, "launches": launches,
               "files": sorted(str(f.relative_to(run)) for f in run.rglob("*") if f.is_file())}
    ok = (all(math.isfinite(out[f"s{i}_{k}"]) for i in (1, 2, 3) for k in ("loss", "psnr"))
          and all(out[f"s{i}_nonfinite_grads"] == 0 for i in (1, 2, 3))
          and all(v <= 1.0 for v in fills.values()) and len(fills) >= 5
          and all(math.isfinite(x) for x in flat)
          and all(launches[k] > 0 for k in kernels.KERNELS)
          and {"stage1/export.npz", "stage2/export.npz", "stage3/export.npz",
               f"ckpts/{s3}.pt"} <= set(summary["files"]))
    phase("scripts_pipeline", **summary, ok=ok)
    if not ok:
        raise AssertionError(f"run_pipeline failed a check: {summary}")
    return summary


def two_spheres_mesh(rows: int, cols: int):
    """The quality scene's two spheres as UV-sphere meshes (numpy vertices,
    faces)."""
    import numpy as np

    from geosplatting_tpu_torch.bench import quality as q

    verts, faces = [], []
    for centre, radius in zip(q.SPHERE_CENTERS, q.SPHERE_RADII):
        m = uv_sphere(rows, cols, float(radius))
        faces.append(m.indices.numpy() + sum(len(v) for v in verts))
        verts.append(m.vertices.numpy() + centre)
    return np.concatenate(verts).astype(np.float32), np.concatenate(faces).astype(np.int32)


def scripts_premask(device, scene: Path, tmp: Path) -> dict:
    """(b) of phase 15: premask on the synthetic scene with the two spheres
    as the mesh, the layout read back through RFMaskedRealDataparser, each
    view's mask against the scene's alpha."""
    import numpy as np

    from geosplatting_tpu_torch.data.dataset import Dataset
    from geosplatting_tpu_torch.graphics.mesh_io import save_mesh
    from geosplatting_tpu_torch.scripts import premask

    c, m = SCRIPTS_DP["scene"], SCRIPTS_DP["mask"]
    verts, faces = two_spheres_mesh(m["rows"], m["cols"])
    save_mesh(tmp / "two_spheres.ply", verts, faces)
    t0 = time.perf_counter()
    info = premask.premask(tmp / "two_spheres.ply", scene, tmp / "masked",
                           scale_factor=c["res"] / 800, tile_capacity=m["tile_capacity"],
                           device=device, log=lambda msg: None)
    seconds = time.perf_counter() - t0
    from geosplatting_tpu_torch.data.dataparsers.real_captures import _modulo_split

    masked = Dataset(tmp / "masked", device=device)
    parser = masked.dataparser
    ratios = (parser.train_split_ratio, parser.val_split_ratio, parser.test_split_ratio)
    order = [i for s in ("train", "test", "val") for i in _modulo_split(info["views"], s, ratios)]
    got = np.concatenate([masked.get_split(s)[1] for s in ("train", "test", "val")])
    gt = Dataset(scene, scale_factor=c["res"] / 800, device=device)
    want = np.concatenate([gt.get_split(s)[1] for s in ("train", "val", "test")])[order]
    ious = []
    for a, b in zip(got[..., 3] > 0.5, want[..., 3] > 0.5):
        ious.append(float((a & b).sum() / max((a | b).sum(), 1)))
    summary = {**info, "faces": len(faces), "seconds": seconds,
               "parser": type(parser).__name__, "read_back": len(got),
               "iou_min": min(ious), "iou": ious, "iou_gate": m["iou"]}
    ok = (summary["parser"] == "RFMaskedRealDataparser" and len(got) == info["views"]
          == len(want) and min(ious) >= m["iou"]
          and info["max_tile_triangles"] <= info["tile_capacity"])
    phase("scripts_premask", **summary, ok=ok)
    if not ok:
        raise AssertionError(f"premask failed a check: {summary}")
    return summary


def _dp_setup(name: str, device, seed, paths: dict):
    """(trainer, cameras, ground truth) of one of (c)'s workloads, built
    alike in every process from the seed and the earlier phases' exports."""
    import dataclasses

    import numpy as np
    import torch

    from geosplatting_tpu_torch.graphics.cameras import Cameras

    gen = torch.Generator(device=device).manual_seed(seed)
    if name == "stage1":
        return make_slice(device, gen, **SLICE)
    if name == "gsplat":
        from geosplatting_tpu_torch.train.gsplat_trainer import (
            GSplatTrainer, GSplatTrainerConfig,
        )

        splats, model, cams, gt = gsplat_scene(device, gen, sh_degree=0)
        trainer = GSplatTrainer(GSplatTrainerConfig(batch_size=len(cams)), model,
                                dataset_size=len(cams))
        trainer.init_state(splats)
        return trainer, cams, gt
    from geosplatting_tpu_torch.engine.stage_io import find_export, load_export

    n = SCRIPTS_DP["stage23_cameras"]
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                              num_samples=n, width=800, height=800, device=device)
    if name == "stage2":
        from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
        from geosplatting_tpu_torch.train.geosplat_mc_trainer import (
            GeoSplatMCTrainer, GeoSplatMCTrainerConfig,
        )

        export = load_export(find_export(paths["product_run"]))
        planes = np.shape(export["ks_enc"]["planes"])
        m2 = GeoSplatterMC(resolution=STAGE2["grid"], scale=STAGE2["scene_scale"],
                           num_samples_x=STAGE2["num_samples_x"],
                           shadow_steps=STAGE2["shadow_steps"], pairs_budget=STAGE2["pairs_budget"],
                           max_render_faces=STAGE2["max_render_faces"],
                           triplane_resolution=planes[1], triplane_components=planes[-1],
                           generator=gen, device=device)
        m2.init_from_stage1(export)
        return GeoSplatMCTrainer(GeoSplatMCTrainerConfig(batch_size=n), m2), cams, sphere_gt(cams)
    from geosplatting_tpu_torch.scripts import train_geosplat_defer as cli3
    from geosplatting_tpu_torch.train.geosplat_defer_trainer import (
        GeoSplatDeferTrainer, GeoSplatDeferTrainerConfig,
    )

    task3 = dataclasses.replace(cli3.TASKS["s4r-twosphere"], load=paths["stage2_run"])
    export3 = load_export(find_export(paths["stage2_run"]))
    m3 = task3.make_model(export3, device)
    m3.init_from_stage2(export3)
    return GeoSplatDeferTrainer(GeoSplatDeferTrainerConfig(batch_size=n), m3), cams, sphere_gt(cams)


DP_SETUPS = ("stage1", "stage2", "stage3", "gsplat")


def _dp_step(name: str, trainer, cams, gt, gen, dp: bool) -> dict:
    fn = trainer.train_step_dp if dp else trainer.train_step
    step = SCRIPTS_DP["step"]
    if name == "stage1":
        return fn(cams, gt, step, sampling="face", generator=gen)
    if name == "stage2":
        return fn(cams, gt, step, generator=gen)
    if name == "stage3":
        return fn(cams, gt, generator=gen)
    return fn(cams, gt, max_sh_degree=None, generator=gen)


def _dp_params(name: str, trainer) -> dict:
    """The trained parameters (3DGS: those with an optimizer group)."""
    if name == "gsplat":
        return {k: trainer.params[k] for k in trainer.specs}
    return dict(trainer.model.named_parameters())


def _sharded_inputs(kind: str, device, seed):
    """(d)'s scenes: bench.py's 3DGS scene for the band render (its 32 pairs
    a Gaussian), 1,008,000 Gaussians on the prior's sphere for the
    Gaussian-sharded one (8 a Gaussian). Returns (dict of the Gaussians'
    tensors, the camera, the rasterizer's keywords)."""
    import torch

    from geosplatting_tpu_torch.graphics import gmath
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "tile":
        splats, _, cams, _ = gsplat_scene(device, gen, sh_degree=0)
        return {"means": splats.means, "quats": gmath.safe_normalize(splats.quats),
                "scales": torch.exp(splats.scales),
                "opacities": torch.sigmoid(splats.opacities[:, 0]),
                "colors": splats.colors}, cams[0], {"pairs_per_gaussian": GSPLAT["pairs_per_gaussian"]}
    n = SCRIPTS_DP["gs_gaussians"]
    kw = dict(generator=gen, device=device)
    pts = torch.randn((n, 3), **kw)
    cam = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=PRIOR["cam_radius"],
                             elevation_degrees=PRIOR["elevation"], num_samples=1,
                             width=PRIOR["resolution"], height=PRIOR["resolution"],
                             device=device)[0]
    return {"means": PRIOR["radius"] * pts / torch.linalg.norm(pts, dim=-1, keepdim=True),
            "quats": gmath.safe_normalize(torch.randn((n, 4), **kw)),
            "scales": torch.exp(torch.rand((n, 3), **kw) * 1.5 - 6.5),
            "opacities": torch.rand(n, **kw) * 0.8 + 0.1,
            "colors": torch.rand((n, 3), **kw)}, cam, {"pairs_per_gaussian": 8}


def _render_loss(render, alpha):
    return (render ** 2).sum() + alpha.sum()


@contextlib.contextmanager
def f64_prefix():
    """The segment sums' prefix (K3) in float64 for the with-block. K3's
    float32 prefix differences carry an error that grows with the running
    prefix (ROADMAP C, "Prefix-difference precision"): at (d)'s 1-2.4M
    pairs it is larger than the bound the sharded renders are held to, so
    their gradients are compared with the prefix in float64 on both sides,
    and the float32 path's differences are reported beside them."""
    import torch

    from geosplatting_tpu_torch.ops import segment_rows as sr

    fn = sr.cumsum_rows
    sr.cumsum_rows = lambda values: torch.cumsum(values.double(), 0).float()
    try:
        yield
    finally:
        sr.cumsum_rows = fn


def _sharded_pass(fn, scene, cam, kw, prefix64: bool):
    """One render and backward of ``render_loss``; (render, alpha, grads,
    seconds)."""
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in scene.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with f64_prefix() if prefix64 else contextlib.nullcontext():
        render, alpha = fn(*leaves.values(), cam.view_matrix, cam.intrinsic_matrix,
                           cam.width, cam.height, **kw)[:2]
        _render_loss(render, alpha).backward()
    torch.cuda.synchronize()
    return render.detach(), alpha.detach(), {k: v.grad for k, v in leaves.items()}, \
        time.perf_counter() - t0


def _rank_train(name: str, rank: int, device, seed, paths: dict, work: Path,
                warnings: list) -> dict:
    """Two train_step_dp of (c)'s workload ``name`` on this rank: the
    first under deterministic algorithms (it is held to one process's),
    rank 0 keeping its gradients; rank 0 records its stage-1 second step's
    last kernel inputs into ``work/captured.pt``. Returns the steps'
    seconds, metrics, rank 0's gradients, the parameters' digests after
    the second step, the launches and the gradients' reduce seconds."""
    import hashlib

    import torch

    from geosplatting_tpu_torch import _kernels
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp
    from geosplatting_tpu_torch.ops import segment_rows as sr
    from geosplatting_tpu_torch.train import dp

    trainer, cams, gt = _dp_setup(name, device, seed, paths)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    recorders = [Recorder(rp, "composite_bwd"), Recorder(sr, "cumsum_rows")]
    seconds, metrics, grads = [], [], None
    launches = {k: 0 for k in _kernels.RASTER_KERNELS}
    with Timed(dp, "reduce_grads") as reduce:
        for i in range(2):
            record = name == "stage1" and rank == 0 and i == 1
            with contextlib.ExitStack() as stack:
                if i == 0:
                    stack.enter_context(deterministic(warnings))
                if record:
                    for r in recorders:
                        stack.enter_context(r)
                torch.cuda.synchronize()
                _kernels.reset_launches()
                t0 = time.perf_counter()
                m = _dp_step(name, trainer, cams, gt, gen, dp=True)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            launches = {k: launches[k] + _kernels.launches[k] for k in _kernels.RASTER_KERNELS}
            if i == 0 and rank == 0:
                # copies: the next step reuses .grad and the statistics in place
                grads = {k: p.grad.detach().clone().cpu()
                         for k, p in _dp_params(name, trainer).items()}
                if name == "gsplat":
                    grads["stats.xys_grad_norm"] = trainer.xys_grad_norm.clone().cpu()
                    grads["stats.vis_counts"] = trainer.vis_counts.clone().cpu()
    if name == "stage1" and rank == 0:
        torch.save({"bwd": recorders[0].args, "k3": recorders[1].args}, work / "captured.pt")
    digests = {k: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
               for k, p in _dp_params(name, trainer).items()}
    return {"seconds": seconds, "metrics": metrics, "grads": grads, "digests": digests,
            "launches": launches, "reduce_seconds": reduce.seconds}


def scripts_dp_rank(rank: int, world: int, work: str, paths: dict, seed: int,
                    device_name: str) -> None:
    """One rank of (c)-(e) of phase 15, in a fresh process on the shared card
    (a gloo group: NCCL refuses two ranks on one device). Writes what it
    measured to ``<work>/rank<r>.pt``."""
    import torch

    from geosplatting_tpu_torch.engine.train_task import GeoSplatTrainTask
    from geosplatting_tpu_torch.parallel.gs_sharding import rasterize_gs_sharded
    from geosplatting_tpu_torch.parallel.sharding import init_from_env, shard_batch
    from geosplatting_tpu_torch.parallel.tile_sharding import rasterize_tile_sharded

    _, _, device = init_from_env(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    out = {"deterministic_warnings": []}
    for name in DP_SETUPS:
        out[name] = _rank_train(name, rank, device, seed, paths, work,
                                out["deterministic_warnings"])
        torch.cuda.empty_cache()

    # (d) the sharded renders, through K3 and with the prefix in float64
    with deterministic(out["deterministic_warnings"]):
        for kind, fn in (("tile", rasterize_tile_sharded), ("gs", rasterize_gs_sharded)):
            scene, cam, kw = _sharded_inputs(kind, device, seed)
            if kind == "gs":
                scene = shard_batch(scene, rank, world)
            render, alpha, grads, seconds = _sharded_pass(fn, scene, cam, kw, False)
            grads_f64 = _sharded_pass(fn, scene, cam, kw, True)[2]
            out[kind] = {"seconds": seconds, "render": render.cpu(), "alpha": alpha.cpu(),
                         "grads": {k: v.cpu() for k, v in grads.items()},
                         "grads_f64": {k: v.cpu() for k, v in grads_f64.items()}}
            del scene, render, alpha, grads, grads_f64
            torch.cuda.empty_cache()

    # (e) a data-parallel task, as torchrun would start it
    (work / "task").mkdir(exist_ok=True)
    os.chdir(work / "task")
    task = GeoSplatTrainTask(
        dataset_path=Path(paths["product_scene"]), experiment_name="dp-product", seed=seed,
        num_steps=SCRIPTS_DP["task_steps"], batch_size=SLICE["cameras"], num_steps_per_save=1,
        num_steps_per_val=SCRIPTS_DP["task_steps"], num_val_images=1, resolution=SLICE["grid"],
        light_resolution=512, scene_scale=0.8, pairs_budget=SLICE["pairs_budget"],
        device=device_name, sdf_sphere_init=PRODUCT["sdf_sphere_init"], data_parallel=True,
        triplane_resolution=SCRIPTS_DP["task_triplane"])
    out["task"] = task.run()
    torch.save(out, work / f"rank{rank}.pt")


def scripts_dp(device, seed, paths: dict, tmp: Path, card: str) -> tuple[dict, dict]:
    """(c)-(e) of phase 15 on two gloo ranks sharing the card, each against
    this process's single-process run of the same workload. Returns (the
    phase's numbers, rank 0's last camera's kernel inputs of (c)'s stage-1
    step with that run's launches)."""
    import torch

    from geosplatting_tpu_torch.engine.stage_io import load_export
    from geosplatting_tpu_torch.ops.rasterize import rasterize
    from geosplatting_tpu_torch.parallel import sharding

    work = tmp / "dp"
    work.mkdir()
    tol = SCRIPTS_DP["tol"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharding.spawn_gloo(scripts_dp_rank, SCRIPTS_DP["world"], work / "rendezvous", str(work),
                        {k: str(v) for k, v in paths.items()}, seed, device.type)
    ranks_s = time.perf_counter() - t0
    # the ranks' own files (tile grids and chunk lists are not plain tensors)
    r0, r1 = (torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2))
    summary = {"label": "two processes sharing one card: correctness and collective overhead, "
                        "not multi-GPU scaling", "card": card, "ranks_seconds": ranks_s}
    ok = True
    warnings = []
    with deterministic(warnings):
        for name in DP_SETUPS:
            trainer, cams, gt = _dp_setup(name, device, seed, paths)
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in _dp_step(name, trainer, cams, gt, gen, dp=False).items()}
            torch.cuda.synchronize()
            single_s = time.perf_counter() - t0
            want = {k: p.grad.detach() for k, p in _dp_params(name, trainer).items()}
            if name == "gsplat":
                want["stats.xys_grad_norm"] = trainer.xys_grad_norm
                want["stats.vis_counts"] = trainer.vis_counts
            rtol, atol = tol[name]
            worst = {"max_abs_err": 0.0, "past_tol": 0, "ok": True}
            for k, w in want.items():
                res = close_to(r0[name]["grads"][k].to(device), w, atol, rtol)
                worst = {"max_abs_err": max(worst["max_abs_err"], res["max_abs_err"]),
                         "past_tol": worst["past_tol"] + res["past_tol"],
                         "ok": worst["ok"] and res["ok"]}
            del trainer, cams, gt, want
            torch.cuda.empty_cache()
            got = r0[name]["metrics"][0]
            loss_err = abs(got["loss"] - m["loss"]) / abs(m["loss"])
            bit_equal = r0[name]["digests"] == r1[name]["digests"]
            entry = {
                "loss_dp": got["loss"], "loss_single": m["loss"], "loss_rel_err": loss_err,
                "grads": {**worst, "rtol": rtol, "atol": atol},
                "params_bit_equal_after_2_steps": bit_equal,
                "nonfinite_grads": [x["nonfinite_grads"] for r in (r0, r1)
                                    for x in r[name]["metrics"]],
                "fills": {k: max(x[k] for r in (r0, r1) for x in r[name]["metrics"])
                          for k in got if k.endswith("_fill")},
                "dp_step_seconds": {"rank0": r0[name]["seconds"], "rank1": r1[name]["seconds"]},
                "single_step_seconds": single_s,
                "dp_reduce_bytes": got["dp_reduce_bytes"],
                "dp_reduce_seconds": {"rank0": r0[name]["reduce_seconds"],
                                      "rank1": r1[name]["reduce_seconds"]},
                "launches_rank0": r0[name]["launches"],
            }
            entry["ok"] = (loss_err <= tol["loss_rtol"] and worst["ok"] and bit_equal
                           and all(v == 0 for v in entry["nonfinite_grads"])
                           and all(v <= 1.0 for v in entry["fills"].values())
                           and all(v > 0 for v in r0[name]["launches"].values()))
            summary[name] = entry
            ok = ok and entry["ok"]
            phase(f"scripts_dp_{name}", **entry)

        for kind, fwd_tol in (("tile", tol["tile_fwd"]), ("gs", tol["gs_fwd"])):
            scene, cam, kw = _sharded_inputs(kind, device, seed)
            render, alpha, grads_k3, single_s = _sharded_pass(rasterize, scene, cam, kw, False)
            grads_f64 = _sharded_pass(rasterize, scene, cam, kw, True)[2]
            pairs = int(rasterize(*scene.values(), cam.view_matrix, cam.intrinsic_matrix,
                                  cam.width, cam.height, **kw)[2]["total_pairs"])
            fwd = [close_to(r[kind][x].to(device), y, fwd_tol, 0.0)
                   for r in (r0, r1) for x, y in (("render", render), ("alpha", alpha))]

            def sharded(key, k):
                parts = [r[kind][key][k] for r in (r0, r1)]
                return (parts[0] if kind == "tile" else torch.cat(parts)).to(device)

            grads, k3_path = {}, {}
            bound = tol["render_grad"]
            for k, want in grads_f64.items():
                scale = max(1.0, float(want.abs().max()))
                grads[k] = {**close_to(sharded("grads_f64", k), want, bound * scale, bound),
                            "atol": bound * scale, "rtol": bound}
                # reported, not gated: the same through K3's float32 prefix
                k3_path[k] = {
                    **close_to(sharded("grads", k), grads_k3[k], bound * scale, bound),
                    "sharded_vs_single_rel": float((sharded("grads", k) - grads_k3[k]).abs()
                                                   .max()) / scale,
                    "single_k3_vs_f64_rel": float((grads_k3[k] - want).abs().max()) / scale}
            entry = {"gaussians": int(scene["means"].shape[0]), "image": [cam.width, cam.height],
                     "pairs": pairs, **kw,
                     "forward": {"max_abs_err": max(f["max_abs_err"] for f in fwd),
                                 "atol": fwd_tol, "ok": all(f["ok"] for f in fwd)},
                     "grads_prefix_f64": grads, "grads_k3_path": k3_path,
                     "sharded_seconds": {"rank0": r0[kind]["seconds"],
                                         "rank1": r1[kind]["seconds"]},
                     "single_seconds": single_s}
            entry["ok"] = (entry["forward"]["ok"] and all(g["ok"] for g in grads.values())
                           and pairs <= kw["pairs_per_gaussian"] * entry["gaussians"])
            if kind == "tile":
                entry["ranks_equal_grads"] = all(
                    torch.equal(r0[kind][key][k], r1[kind][key][k])
                    for key in ("grads", "grads_f64") for k in grads)
                entry["ok"] = entry["ok"] and entry["ranks_equal_grads"]
            summary[f"sharded_{kind}"] = entry
            ok = ok and entry["ok"]
            phase(f"scripts_dp_sharded_{kind}", **entry)
            del scene, render, alpha, grads_k3, grads_f64
            torch.cuda.empty_cache()

    # (e) only rank 0 wrote a run directory; its export equals its checkpoint
    runs = sorted((work / "task" / "outputs").glob("*/*"))
    run = Path(r0["task"]["output_dir"])
    run = run if run.is_absolute() else work / "task" / run
    files = sorted(str(f.relative_to(run)) for f in run.rglob("*") if f.is_file())
    exported = load_export(run)
    ckpt = torch.load(run / "ckpts" / f"{SCRIPTS_DP['task_steps']}.pt", map_location="cpu")
    from geosplatting_tpu_torch.convert import params_to_numpy

    params = params_to_numpy(ckpt["model"])
    mismatched = [k for k in ("sdf", "deform", "weights", "cubemap", "exposure")
                  if not (exported[k] == params[k]).all()]
    task = {"runs": [str(p) for p in runs], "rank1_output_dir": r1["task"]["output_dir"],
            "files": files, "export_mismatched": mismatched,
            "loss": [r0["task"]["loss"], r1["task"]["loss"]],
            "val_psnr": r0["task"].get("val_psnr"), "nonfinite_grads": r0["task"]["nonfinite_grads"],
            "pair_fill": r0["task"]["pair_fill"]}
    task["ok"] = (len(runs) == 1 and runs[0].resolve() == run.resolve()
                  and r1["task"]["output_dir"] is None and not mismatched
                  and {"task.py", "export.npz", "log.txt", "ckpts/1.pt", "ckpts/2.pt"} <= set(files)
                  and task["loss"][0] == task["loss"][1] and task["nonfinite_grads"] == 0
                  and task["pair_fill"] <= 1.0)
    summary["task"] = task
    phase("scripts_dp_task", **task)
    summary["deterministic_warnings"] = sorted(set(warnings + r0["deterministic_warnings"]))
    ok = ok and task["ok"]
    if not ok:
        raise AssertionError(f"phase 15's data-parallel checks failed: {summary}")
    captured = torch.load(work / "captured.pt", map_location=device, weights_only=False)
    return summary, {"captured": captured, "launches": r0["stage1"]["launches"], "steps": 2}


def scripts_and_dp(device, seed, kernels, paths: dict, tmp: Path, card: str
                   ) -> tuple[dict, dict]:
    """Phase 15 of the docstring, (a)-(e)."""
    out = {"pipeline": scripts_pipeline(device, seed, kernels, tmp)}
    out["premask"] = scripts_premask(device, Path(out["pipeline"]["scene"]), tmp)
    out["dp"], captured = scripts_dp(device, seed, paths, tmp, card)
    return out, captured


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # a fixed cuBLAS workspace, set before the first cuBLAS call: phase 14's
    # deterministic comparisons need it (``deterministic``)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from geosplatting_tpu_torch import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    start = t0 = time.perf_counter()
    seconds = {}
    smi = toolchain(_kernels)
    seconds["toolchain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    errors = {"k3": check_k3(device, gen)["max_abs_err"], **check_k1_k2(device, gen)}
    check_sdf_trace(device, gen)
    check_mc_shade(device, gen)
    check_render_card_vs_cpu(device, args.seed)
    seconds["kernel_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    summary, captured = train_slice(device, args.seed, _kernels)
    face = summary["face_step_seconds"]
    phase("slice", launches=summary["launches"], face_step_seconds=face,
          median_face_step_s=sorted(face)[len(face) // 2], card=smi,
          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    seconds["slice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line = kernel_line(captured, summary, errors)
    del captured
    seconds["kernels_line"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as tmp:
        t0 = time.perf_counter()
        prod = product(device, args.seed, _kernels, Path(tmp))
        seconds["product"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s2, captured = stage2(device, args.seed, _kernels, Path(tmp) / "scene",
                              Path(prod["run_dir"]))
        seconds["stage2"] = time.perf_counter() - t0
        # the kernels held to their plain versions again, at stage 2's inputs
        t0 = time.perf_counter()
        measured = measure_kernels(captured, s2["launches"], len(s2["steps"]))
        del captured
        phase("kernels_vs_plain_at_stage2", **measured["checks"], **measured["counts"],
              max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
              tol=TOLERANCES)
        for entry in line["kernels"]:
            entry["stage2"] = measured["rows"][entry["name"]]
        seconds["kernels_stage2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s3, captured = chain(device, args.seed, _kernels, Path(tmp))
        seconds["chain"] = time.perf_counter() - t0
        # and at the inputs of stage 3's last G-buffer camera (C = 14)
        t0 = time.perf_counter()
        measured = measure_kernels(captured, s3["launches"], len(s3["stage3_steps"]))
        del captured
        phase("kernels_vs_plain_at_stage3", **measured["checks"], **measured["counts"],
              max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
              tol=TOLERANCES)
        for entry in line["kernels"]:
            entry["stage3"] = measured["rows"][entry["name"]]
        seconds["kernels_stage3"] = time.perf_counter() - t0
        # 3DGS: bench.py's workload, SH 3 with densification, the task
        t0 = time.perf_counter()
        bench, captured = gsplat_bench(device, args.seed, _kernels)
        phase("gsplat_bench", **bench, card=smi)
        dens = gsplat_densify(device, args.seed)
        phase("gsplat_densify", **dens)
        gtask = gsplat_task(device, args.seed, _kernels, Path(tmp) / "scene")
        phase("gsplat_task", **gtask)
        seconds["gsplat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        measured = measure_kernels(captured, bench["launches"], GSPLAT["timed_steps"])
        del captured
        phase("kernels_vs_plain_at_gsplat", **measured["checks"], **measured["counts"],
              max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
              tol=TOLERANCES)
        for entry in line["kernels"]:
            entry["gsplat"] = measured["rows"][entry["name"]]
        seconds["kernels_gsplat"] = time.perf_counter() - t0
        # the mesh prior: the 1M-Gaussian sphere, the hash field, the task
        t0 = time.perf_counter()
        prior, captured = prior_train(device, args.seed, _kernels, hash_field=False)
        phase("prior_scale", **prior, card=smi)
        prior_hash, _ = prior_train(device, args.seed, _kernels, hash_field=True)
        phase("prior_hash_field", **prior_hash, card=smi)
        ptask = prior_task(device, args.seed, _kernels, Path(tmp) / "scene", Path(tmp))
        phase("prior_task", **ptask)
        seconds["prior"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        measured = measure_kernels(captured, prior["launches"], PRIOR["timed_steps"])
        del captured
        phase("kernels_vs_plain_at_prior", **measured["checks"], **measured["counts"],
              max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
              tol=TOLERANCES)
        for entry in line["kernels"]:
            entry["prior"] = measured["rows"][entry["name"]]
        seconds["kernels_prior"] = time.perf_counter() - t0
        # 2DGS: bench.py's scene, the depth modes, the blender-2dgs task
        t0 = time.perf_counter()
        train2d = gsplat2d_train(device, args.seed)
        phase("gsplat2d_train", **train2d, card=smi)
        depth, captured = gsplat2d_depth(device, args.seed, _kernels)
        phase("gsplat2d_depth", **depth)
        task2d = gsplat2d_task(device, args.seed, Path(tmp) / "scene", Path(tmp))
        phase("gsplat2d_task", **task2d)
        check_2dgs_card_vs_cpu(device, args.seed)
        seconds["gsplat2d"] = time.perf_counter() - t0
        # the capture layouts: COLMAP, Stanford-ORB, DTU, MeshPBR, geometry
        t0 = time.perf_counter()
        caps, captured_caps = captures(device, args.seed, _kernels, Path(tmp), smi)
        seconds["captures"] = time.perf_counter() - t0
        seconds.update({f"captures_{k}": v for k, v in caps["seconds"].items()})
        # the quality benchmark's chain and the turntable / HTML tooling
        t0 = time.perf_counter()
        qual, captured_quality = quality(device, args.seed, _kernels, Path(tmp) / "scene", smi)
        seconds["quality"] = time.perf_counter() - t0
        # the camera-batched rasterizer against the per-camera path
        t0 = time.perf_counter()
        bat, captured_batched = batched(
            device, args.seed, _kernels, Path(prod["run_dir"]), Path(s3["stage2_run_dir"]), smi,
            sorted(face)[len(face) // 2], bench["median_step_s"])
        seconds["batched"] = time.perf_counter() - t0
        # the root entry scripts, then two gloo ranks sharing the card
        t0 = time.perf_counter()
        (Path(tmp) / "scripts_dp").mkdir()
        sdp, captured_dp = scripts_and_dp(
            device, args.seed, _kernels,
            {"product_run": Path(prod["run_dir"]), "stage2_run": Path(s3["stage2_run_dir"]),
             "product_scene": Path(tmp) / "scene"}, Path(tmp) / "scripts_dp", smi)
        seconds["scripts_dp"] = time.perf_counter() - t0
    # the kernels held to their plain versions at the differentiated ED
    # render's inputs: K2's gradient has a non-zero depth row there
    t0 = time.perf_counter()
    measured = measure_kernels(captured, depth["launches"], 1)
    del captured
    phase("kernels_vs_plain_at_depth", **measured["checks"], **measured["counts"],
          max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
          tol=TOLERANCES, depth_grad_max=depth["depth_grad_max"])
    for entry in line["kernels"]:
        entry["depth"] = measured["rows"][entry["name"]]
    seconds["kernels_depth"] = time.perf_counter() - t0
    # and at the inputs of the COLMAP prior run's last camera (1297 x 840:
    # edge tiles 1 px wide and 8 px tall)
    t0 = time.perf_counter()
    measured = measure_kernels(captured_caps, caps["prior"]["launches"],
                               CAPTURES["prior_resume_to"])
    del captured_caps
    phase("kernels_vs_plain_at_captures", **measured["checks"], **measured["counts"],
          max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
          tol=TOLERANCES)
    for entry in line["kernels"]:
        entry["captures"] = measured["rows"][entry["name"]]
    seconds["kernels_captures"] = time.perf_counter() - t0
    # and at the quality chain's: stage 2's last camera (C = 3) and stage 3's
    # last G-buffer camera (C = 14), 32 x 32 images of 2 x 2 tiles
    t0 = time.perf_counter()
    stages = qual["chain"]["stages"]
    for name, stage in (("quality_stage2", "s2"), ("quality", "s3")):
        measured = measure_kernels(captured_quality[stage], stages[stage]["launches"],
                                   stages[stage]["steps"])
        phase(f"kernels_vs_plain_at_{name}", **measured["checks"], **measured["counts"],
              max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
              tol=TOLERANCES)
        for entry in line["kernels"]:
            entry[name] = measured["rows"][entry["name"]]
    del captured_quality
    seconds["kernels_quality"] = time.perf_counter() - t0
    # and at the batched slice's: K1-K3 fed by the one-pass binning
    t0 = time.perf_counter()
    measured = measure_kernels(captured_batched, bat["slice"]["launches"],
                               bat["slice"]["steps"])
    del captured_batched
    phase("kernels_vs_plain_at_batched", **measured["checks"], **measured["counts"],
          max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
          tol=TOLERANCES)
    for entry in line["kernels"]:
        entry["batched"] = measured["rows"][entry["name"]]
    seconds["kernels_batched"] = time.perf_counter() - t0
    # and at rank 0's last camera of phase 15's data-parallel stage-1 step
    t0 = time.perf_counter()
    measured = measure_kernels(captured_dp["captured"], captured_dp["launches"],
                               captured_dp["steps"])
    del captured_dp
    phase("kernels_vs_plain_at_scripts_dp", **measured["checks"], **measured["counts"],
          max_abs_err={k: r["max_abs_err"] for k, r in measured["rows"].items()},
          tol=TOLERANCES)
    for entry in line["kernels"]:
        entry["scripts_dp"] = measured["rows"][entry["name"]]
    seconds["kernels_scripts_dp"] = time.perf_counter() - t0
    phase("phase_seconds", **seconds, total=time.perf_counter() - start)
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
