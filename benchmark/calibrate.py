#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--program] [--control]
        [--fault state_unchanged|answer_altered ...]

For each seed, the reference's compared steps (a training cell) or a
sampled chunk (a relight cell) once, then, as asked, the program's, the
control's (the reference in the precision below the configuration's: TF32)
and the program's with each fault of ``faults.py`` planted, each compared
with the reference as ``compare.py`` compares a run. One JSON line per seed
and side; the last line gives each number's largest program reading and
smallest control and fault readings. Runs on a CUDA device only.
"""
import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(c: dict, seed: int, device, sides: list[str]) -> dict:
    import torch

    from benchmark import compare, faults, harness, traffic as tr
    from benchmark.systems.common import PROGRAM, REFERENCE, package

    t, b = c["traffic"], c["system"]
    out = {}
    if t["mode"] == "train":
        gt = tr.ground_truth(tr.orbit(package(REFERENCE), t, device), list(range(t["views"])))

        def steps(root, control, fault=None):
            compare.full_precision()
            with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
                r = harness.TrainRun(c, package(root), seed, device).compared_steps(gt, control)
            gc.collect()
            torch.cuda.empty_cache()
            return r

        ref = steps(REFERENCE, False)
        out["raw_reference"] = {k: v for k, v in ref.items() if k != "image"}
        for side in sides:
            fault = side.split(":")[1] if side.startswith("fault:") else None
            got = steps(REFERENCE if side == "control" else PROGRAM, side == "control", fault)
            out[side] = compare.train_numbers(got, ref)
            out[f"raw_{side}"] = {k: v for k, v in got.items() if k != "image"}
        return out
    shapes = b.shapes(package(REFERENCE), c["cfg"], t)
    order = tr.view_order(t, seed)
    scene = tr.relight_scene(t, seed, device)
    views = tr.chunk_views(t, order, 1)
    draws = tr.chunk_draws(t, seed, 1, shapes, device)

    def chunk(root, control, fault=None):
        compare.full_precision()
        pkg = package(root)
        model = b.build_model(pkg, c["cfg"], tr.generator(device, seed, 0, tr.SALT_WEIGHTS),
                              device)
        if control:
            compare.lower_precision()
        with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
            img, _ = b.relight(pkg, model, tr.orbit(pkg, t, device)[views], draws, scene)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return img.cpu()

    want = chunk(REFERENCE, False)
    for side in sides:
        fault = side.split(":")[1] if side.startswith("fault:") else None
        got = chunk(REFERENCE if side == "control" else PROGRAM, side == "control", fault)
        out[side] = compare.image_gaps(got, want)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", nargs="*", default=[])
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness

    device = torch.device("cuda", 0)
    c = harness.cell(args.workload)
    sides = [s for s in ("program", "control") if getattr(args, s)]
    sides += [f"fault:{f}" for f in args.fault]
    worst = {}
    for seed in args.seeds:
        got = readings(c, seed, device, sides)
        for side, nums in got.items():
            print(json.dumps({"seed": seed, "side": side, **nums}), flush=True)
            if side.startswith("raw_"):
                continue
            for k, v in nums.items():
                if isinstance(v, (int, float)):
                    pick = max if side == "program" else min
                    key = f"{side}.{k}"
                    worst[key] = pick(worst.get(key, v), v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "largest_program_smallest_control": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
