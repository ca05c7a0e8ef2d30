#!/usr/bin/env python3
"""Where one stage-1 train step of the PyTorch port spends its time, on one GPU.

    [BATCHED_BINNING=1] python3 profile_torch_stage1.py [--steps 5] [--seed 0] [--out summary.json]

Builds chip_smoke.py's full-width slice (grid 96, 8 cameras at 800x800,
pairs budget 1.4M), runs one vertex step and two face steps to warm up,
times ``--steps`` face steps with the host clock around synchronised steps,
then traces one more face step with torch.profiler. It prints, one JSON line
each: the timed steps; the traced step's wall time, the device's busy time
(the sum of its kernels' times) and idle share; host and device time per
span of the port (trainer.*, geosplat.*, rasterize.*); and the 25 kernels
with the most device time. The last line is the summary, which ``--out``
also writes to a file. Without a CUDA device it exits non-zero.
``BATCHED_BINNING=1`` builds the slice with ``batched_binning`` (every
camera binned in one pass).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import SLICE, make_slice, phase


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_stage1: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    batched = os.environ.get("BATCHED_BINNING", "0") == "1"
    trainer, cams, gt = make_slice(device, gen, **SLICE, batched_binning=batched)

    def step(i: int, sampling: str = "face") -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(cams, gt, float(i), sampling=sampling, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step(0, "vertex")
    step(200)
    step(201)
    seconds = [step(202 + i) for i in range(args.steps)]
    phase("timed_face_steps", card=smi, seconds=seconds,
          median_s=statistics.median(seconds))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_s = step(202 + args.steps)
    events = prof.events()

    def is_span(e) -> bool:
        return e.name.startswith(("trainer.", "geosplat.", "rasterize."))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not is_span(e)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    phase("traced_step", card=smi, wall_s=traced_s, device_busy_s=busy_us / 1e6,
          device_idle_share=max(0.0, 1.0 - busy_us / 1e6 / traced_s),
          kernel_launches=len(kernels))

    # host: the span's time on the host; device_extent: first kernel start to
    # last kernel end of the span on the device timeline (spans whose kernels
    # run on autograd's thread, such as trainer.backward, show none)
    spans: dict[str, dict] = {}
    for e in events:
        if is_span(e):
            row = spans.setdefault(e.name, {"calls": 0, "host_s": 0.0, "device_extent_s": 0.0})
            if e.device_type == DeviceType.CUDA:
                row["device_extent_s"] += e.time_range.elapsed_us() / 1e6
            else:
                row["calls"] += 1
                row["host_s"] += e.time_range.elapsed_us() / 1e6
    phase("spans", spans=spans)
    by_kernel: dict[str, list[float]] = {}
    for e in kernels:
        by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:25]
    top_rows = [{"kernel": name[:120], "launches": len(ts), "device_s": sum(ts) / 1e6,
                 "share_of_busy": sum(ts) / max(busy_us, 1e-9)} for name, ts in top]
    phase("top_kernels", kernels=top_rows)

    summary = {
        "card": smi, "slice": SLICE, "batched_binning": batched,
        "median_face_step_s": statistics.median(seconds),
        "face_step_s": seconds, "traced_step_s": traced_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / traced_s),
        "spans": spans, "top_kernels": top_rows,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
