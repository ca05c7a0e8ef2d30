#!/usr/bin/env python
"""Quality benchmark on the card: trains the three-stage chain on the
analytic two-sphere PBR scene (``bench/quality.py``) and reports NVS /
relight / albedo PSNR, the roughness MSE, the stage-1 train PSNR and each
stage's seconds a step and peak memory (counterpart of
``scripts/quality_bench.py``).

    python -m geosplatting_tpu_torch.scripts.quality_bench

The defaults are the reference recipe's shape: 800^2 images, grid 96,
500 / 500 / 100 steps, batch 8. The reduced shape:

    QB_RES=128 QB_GRID=48 QB_S1=200 QB_S2=100 QB_S3=50 QB_BATCH=4 \\
        python -m geosplatting_tpu_torch.scripts.quality_bench

Knobs (environment): QB_RES, QB_GRID, QB_TRAIN_VIEWS, QB_TEST_VIEWS,
QB_BATCH, QB_S1 / QB_S2 / QB_S3 (steps), QB_GT_SPP_X, QB_TRAIN_SPP_X,
QB_LIGHT_RES, QB_SEED, QB_ENV_QUALITY (fast | exact),
QB_FAST_METRICS (1: PSNR only), QB_PAIRS_BUDGET, QB_MAX_FACES, and the
port's QB_DEVICE (the card unless "cpu"); the JAX script's QB_TILE_CAP has
no counterpart (the port's pairs rasterizer has no tile capacity). Each
stage prints one JSON line as it ends
(``{"stage": ...}``), so a run cut short keeps its finished stages'
numbers; the last line is the whole result as one JSON object, with the
card's name and power limit and the kernels' launches in the run.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.bench.quality_chain import run_quality_chain


def card() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, if it answers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    env = os.environ.get
    t0 = time.time()
    device = env("QB_DEVICE")
    smi = card() if device != "cpu" else None

    def on_stage(name: str, numbers: dict) -> None:
        print(json.dumps({"stage": name, **numbers, "card": smi}), flush=True)

    r = run_quality_chain(
        img_res=int(env("QB_RES", 800)),
        grid_res=int(env("QB_GRID", 96)),
        n_train=int(env("QB_TRAIN_VIEWS", 24)),
        n_test=int(env("QB_TEST_VIEWS", 4)),
        batch=int(env("QB_BATCH", 8)),
        s1_steps=int(env("QB_S1", 500)),
        s2_steps=int(env("QB_S2", 500)),
        s3_steps=int(env("QB_S3", 100)),
        gt_spp_x=int(env("QB_GT_SPP_X", 16)),
        train_spp_x=int(env("QB_TRAIN_SPP_X", 4)),
        light_resolution=int(env("QB_LIGHT_RES", 128)),
        seed=int(env("QB_SEED", 0)),
        env_quality=env("QB_ENV_QUALITY", "fast"),
        fast_metrics=env("QB_FAST_METRICS", "1") == "1",
        pairs_budget=int(env("QB_PAIRS_BUDGET")) if env("QB_PAIRS_BUDGET") else None,
        # the padded face slots drive every per-Gaussian cost of stages 1-2
        # (watch face_fill)
        max_render_faces=int(env("QB_MAX_FACES", 1 << 18)),
        device=device,
        log=lambda m: print(m, flush=True),
        on_stage=on_stage,
    )
    r["wall_s"] = time.time() - t0
    r["card"] = smi
    r["launches"] = {k: _kernels.launches[k] for k in _kernels.KERNELS}
    print(json.dumps(r))


if __name__ == "__main__":
    main()
