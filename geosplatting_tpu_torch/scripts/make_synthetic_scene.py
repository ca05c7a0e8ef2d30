#!/usr/bin/env python
"""Write the analytic two-sphere PBR scene (``bench/quality.py``) in the
Syn4Relight layout, so the three-stage chain (``eval_torch.sh``,
``run_pipeline``) runs without a download (counterpart of
``scripts/make_synthetic_scene.py``).

    python -m geosplatting_tpu_torch.scripts.make_synthetic_scene \\
        [--scene_dir data/Synthetic4Relight/twosphere --n_train 100 --n_test 8 \\
         --res 800 --gt_spp_x 16 --seed 11 --device cuda]

Layout written (what ``Syn4RelightDataparser`` reads):

  <scene>/transforms_{train,test}.json      stored-space c2w + camera_angle_x
  <scene>/train/r_i_rgb.hdr + r_i_mask.png  linear HDR frames + masks
  <scene>/test/r_i_rgba.png                 sRGB premultiplied NVS ground truth
  <scene>/test/r_i_albedo.png, r_i_rough.png  material ground truth
  <scene>/test_rli/envmap6_r_i.png, envmap12_r_i.png  relit ground truth
  <scene>/../envmap6.hdr, envmap12.hdr      the relight probes (lat-long, linear)

The stored c2w is the inverse of the parser's axis swap and 2/3 scale: the
script writes an orbit, parses it back through the port's ``Dataset``, and
renders the ground truth from the parsed cameras, so the frames agree with
the cameras the trainer sees. The layout is fixed at 800^2: the views are
rendered at ``--res`` (which must divide 800) and upsampled to 800^2 by
repetition, which the trainer's own ``scale_factor`` undoes.

The JAX script's environment knobs (SCENE_DIR, N_TRAIN, N_TEST, RES,
GT_SPP_X) are flags here with the same defaults. The Monte-Carlo draws of
view i come from a ``torch.Generator`` seeded ``seed + i`` (train), ``seed
+ 7000 + i`` (test) and ``seed + 9000 + i`` (both relit frames), the JAX
script's ``fold_in`` offsets of its key 11; torch's generator is not JAX's
threefry, so the frames are not the JAX script's bit for bit.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.bench import quality as q
from geosplatting_tpu_torch.data.dataset import Dataset
from geosplatting_tpu_torch.data.io import dump_float32_image
from geosplatting_tpu_torch.graphics import images as gimages

CAMERA_ANGLE_X = 0.8575560272  # ~49 deg: the [-1, 1] box fills the frame
LAYOUT_RES = 800
TRAIN_SEED_OFFSET, TEST_SEED_OFFSET, RELIGHT_SEED_OFFSET = 0, 7000, 9000


def stored_orbit_c2w(n: int, radius: float, elev_deg: float, phase: float) -> np.ndarray:
    """[n, 4, 4] stored-space orbit looking at the origin. The parser maps
    stored to parsed space by rows (-y, z, -x) and scales translations by
    2/3; an orbit is closed under a signed axis permutation, so the parsed
    cameras orbit the origin at radius * 2/3."""
    out = []
    for i in range(n):
        th = 2 * np.pi * (i + phase) / n
        el = np.deg2rad(elev_deg)
        eye = radius * np.array([np.cos(th) * np.cos(el), np.sin(th) * np.cos(el), np.sin(el)])
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), 1e-8)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        out.append(c2w)
    return np.stack(out)


def write_transforms(out: Path, split: str, n: int, elev_deg: float, phase: float) -> None:
    c2ws = stored_orbit_c2w(n, radius=2.2 * 1.5, elev_deg=elev_deg, phase=phase)
    frames = [{"file_path": f"./{split}/r_{i}", "transform_matrix": c2ws[i].tolist()}
              for i in range(n)]
    (out / split).mkdir(parents=True, exist_ok=True)
    with open(out / f"transforms_{split}.json", "w") as f:
        json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def train_frame(rgba: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A premultiplied sRGB ground-truth view -> the S4R train frame's
    (linear HDR rgb, mask)."""
    a = rgba[..., 3:]
    srgb = np.where(a > 0, rgba[..., :3] / np.maximum(a, 1e-6), 0.0)
    linear = gimages.srgb2rgb(torch.from_numpy(srgb.astype(np.float32))).numpy()
    return np.clip(linear, 0, None).astype(np.float32), a


def upsample(img: np.ndarray, up: int) -> np.ndarray:
    """[h, w, c] -> [h * up, w * up, c] by repeating each pixel."""
    return img if up == 1 else np.kron(img, np.ones((up, up, 1), np.float32))


def make_scene(out: Path, *, n_train: int = 100, n_test: int = 8, res: int = LAYOUT_RES,
               spp_x: int = 16, seed: int = 11, device=None, log=print) -> Path:
    """Write the scene under ``out``; returns ``out``."""
    if LAYOUT_RES % res:
        raise ValueError(f"res must divide {LAYOUT_RES}, got {res}")
    device = _kernels.resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    # two orbits: the train views low, the test views higher and between them
    write_transforms(out, "train", n_train, elev_deg=22.0, phase=0.0)
    write_transforms(out, "test", n_test, elev_deg=32.0, phase=0.37)

    env_train = q.make_envmap(kind="train", device=device)
    env_relight = q.make_envmap(kind="relight", device=device)
    # a second held-out probe: the relight environment yawed half a turn
    env_relight2 = torch.roll(env_relight, env_relight.shape[1] // 2, dims=1)
    dump_float32_image(out.parent / "envmap6.hdr", env_relight.cpu().numpy())
    dump_float32_image(out.parent / "envmap12.hdr", env_relight2.cpu().numpy())

    # placeholder frames, so that the parse below finds every file; the
    # ground truth rendered from the parsed cameras replaces them
    full = (LAYOUT_RES, LAYOUT_RES)
    for i in range(n_train):
        dump_float32_image(out / "train" / f"r_{i}_rgb.hdr", np.zeros(full + (3,), np.float32))
        dump_float32_image(out / "train" / f"r_{i}_mask.png", np.zeros(full + (1,), np.float32))
    for i in range(n_test):
        for name in ("rgba", "albedo", "rough"):
            dump_float32_image(out / "test" / f"r_{i}_{name}.png", np.zeros(full + (4,)))
        for name in ("envmap6", "envmap12"):
            dump_float32_image(out / "test_rli" / f"{name}_r_{i}.png", np.zeros(full + (4,)))

    up = LAYOUT_RES // res
    ds = Dataset(out, scale_factor=res / LAYOUT_RES, device=device)
    log(f"recognized parser: {type(ds.dataparser).__name__}")

    def render(cams, i, env, seed_i) -> np.ndarray:
        return q.render_gt_views(cams[i:i + 1], env, _generator(device, seed_i),
                                 spp_x)[0].cpu().numpy()

    cams_train, _, _ = ds.get_split("train")
    cams_test, _, _ = ds.get_split("test")
    log(f"rendering {n_train} train views ({res}^2, spp_x={spp_x})...")
    for i in range(n_train):
        linear, a = train_frame(render(cams_train, i, env_train, seed + TRAIN_SEED_OFFSET + i))
        dump_float32_image(out / "train" / f"r_{i}_rgb.hdr", upsample(linear, up))
        dump_float32_image(out / "train" / f"r_{i}_mask.png", upsample(a, up))

    log(f"rendering {n_test} test views, materials and relit views...")
    albedo, rough = (x.cpu().numpy() for x in q.gt_material_maps(cams_test))
    for i in range(n_test):
        nvs = render(cams_test, i, env_train, seed + TEST_SEED_OFFSET + i)
        dump_float32_image(out / "test" / f"r_{i}_rgba.png", upsample(nvs, up))
        dump_float32_image(out / "test" / f"r_{i}_albedo.png", upsample(albedo[i], up))
        rough_rgba = np.concatenate([np.repeat(rough[i][..., 0:1], 3, -1), rough[i][..., 1:2]], -1)
        dump_float32_image(out / "test" / f"r_{i}_rough.png", upsample(rough_rgba, up))
        for name, env in (("envmap6", env_relight), ("envmap12", env_relight2)):
            rl = render(cams_test, i, env, seed + RELIGHT_SEED_OFFSET + i)
            dump_float32_image(out / "test_rli" / f"{name}_r_{i}.png", upsample(rl, up))
    log(f"done: {out}")
    return out


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene_dir", type=Path, default=Path("data/Synthetic4Relight/twosphere"))
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--res", type=int, default=LAYOUT_RES)
    ap.add_argument("--gt_spp_x", type=int, default=16)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    return make_scene(args.scene_dir, n_train=args.n_train, n_test=args.n_test, res=args.res,
                      spp_x=args.gt_spp_x, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
