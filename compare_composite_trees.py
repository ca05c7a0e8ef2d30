#!/usr/bin/env python3
"""Times the compositing kernels K1 and K2 of two trees of the port on the
same inputs, on one GPU.

    python3 compare_composite_trees.py capture --out DIR/inputs.pt [--seed 0]
    python3 compare_composite_trees.py time --inputs DIR/inputs.pt --tree TREE \
        [--kc 256 ...]

``capture`` builds chip_smoke.py's full-width stage-1 slice, runs one vertex
step and two face steps, and saves the inputs of the last camera's K2 call
(pair rows, tile ranges, output gradients) with the counts of the work they
need (chip_smoke.pair_pixel_counts). ``time`` imports
``geosplatting_tpu_torch`` from TREE (the root of a checkout of any commit
of the port), runs its K1 and K2 wrappers on those inputs (at each ``--kc``
where the tree cuts tiles into chunks) and prints one JSON line: the card,
the tree, and the median CUDA-event milliseconds of K1 and K2 and of each of
their passes. Run the trees in turns in one call on one card (old, new, new,
old): times from two calls may come from two cards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def capture(out: Path, seed: int) -> dict:
    import torch

    from chip_smoke import SLICE, Recorder, make_slice, pair_pixel_counts
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    trainer, cams, gt = make_slice(device, gen, **SLICE)
    for step, sampling in ((0, "vertex"), (200, "face")):
        trainer.train_step(cams, gt, float(step), sampling=sampling, generator=gen)
    with Recorder(rp, "composite_bwd") as rec:
        trainer.train_step(cams, gt, 201.0, sampling="face", generator=gen)
    pairs, seg_start, grid, channels, grad_out, _, n_contrib, max_pairs = rec.args[:8]
    counts = pair_pixel_counts(pairs, seg_start, grid, n_contrib)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"pairs": pairs[:, :rp.HDR + channels].cpu(), "seg_start": seg_start.cpu(),
                "grid": tuple(grid), "channels": channels, "grad_out": grad_out.cpu(),
                "max_pairs": max_pairs, "counts": counts}, out)
    return {"phase": "capture", "card": card(), "inputs": str(out), **counts}


def time_tree(inputs: Path, tree: Path, kcs: list[int]) -> dict:
    sys.path.insert(0, str(tree.resolve()))
    import torch

    from chip_smoke import cuda_ms
    from geosplatting_tpu_torch.ops import rasterize_pairs as rp

    assert Path(rp.__file__).resolve().is_relative_to(tree.resolve()), rp.__file__
    saved = torch.load(inputs)
    dev = torch.device("cuda")
    grid = rp.TileGrid(*saved["grid"])
    ch, max_pairs = saved["channels"], saved["max_pairs"]
    seg = saved["seg_start"].to(dev)
    g = saved["grad_out"].to(dev)
    rows = saved["pairs"].to(dev)
    row = {"phase": "time", "card": card(), "tree": str(tree), "counts": saved["counts"]}
    if not hasattr(rp, "chunk_list"):  # one CTA per tile, one pass each way
        out, tf, nc = rp.composite_fwd(rows, seg, grid, ch)
        row["k1_ms"] = cuda_ms(lambda: rp.composite_fwd(rows, seg, grid, ch), 20)
        row["k2_ms"] = cuda_ms(
            lambda: rp.composite_bwd(rows, seg, grid, ch, g, tf, nc, max_pairs), 20)
        return row
    pairs = torch.nn.functional.pad(rows, (0, rp.row_stride(ch) - rows.shape[1])).contiguous()
    row["by_kc"] = {}
    for kc in kcs:
        chunks = rp.chunk_list(seg, max_pairs, kc)
        prod = rp.chunk_products(pairs, seg, grid, ch, chunks)
        out, tf, nc = rp.composite_fwd(pairs, seg, grid, ch, chunks, prod)
        suffix = rp.chunk_suffix(pairs, seg, grid, ch, chunks, prod, g, nc)

        def k1():
            p = rp.chunk_products(pairs, seg, grid, ch, chunks)
            return rp.composite_fwd(pairs, seg, grid, ch, chunks, p)

        def k2():
            s = rp.chunk_suffix(pairs, seg, grid, ch, chunks, prod, g, nc)
            return rp.composite_bwd(pairs, seg, grid, ch, g, tf, nc, max_pairs, chunks, prod, s)

        row["by_kc"][kc] = {
            "chunks": int(chunks.tile_chunk_start[-1]),
            "k1_ms": cuda_ms(k1, 20),
            "k2_ms": cuda_ms(k2, 20),
            "k1_chunk_products_ms": cuda_ms(
                lambda: rp.chunk_products(pairs, seg, grid, ch, chunks), 20),
            "k1_composite_fwd_ms": cuda_ms(
                lambda: rp.composite_fwd(pairs, seg, grid, ch, chunks, prod), 20),
            "k2_chunk_suffix_ms": cuda_ms(
                lambda: rp.chunk_suffix(pairs, seg, grid, ch, chunks, prod, g, nc), 20),
            "k2_composite_bwd_ms": cuda_ms(
                lambda: rp.composite_bwd(pairs, seg, grid, ch, g, tf, nc, max_pairs, chunks,
                                         prod, suffix), 20),
        }
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("--out", type=Path, required=True)
    cap.add_argument("--seed", type=int, default=0)
    tim = sub.add_parser("time")
    tim.add_argument("--inputs", type=Path, required=True)
    tim.add_argument("--tree", type=Path, required=True)
    tim.add_argument("--kc", type=int, nargs="+", default=[256])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("compare_composite_trees: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if args.cmd == "capture":
        row = capture(args.out, args.seed)
    else:
        row = time_tree(args.inputs, args.tree, args.kc)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
