"""One run of one cell: set-up, the measured window, the check, the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` (its
configuration, traffic, limits and ``why``), ``configs/<config>.json`` (its
sizes and its ``system`` module under ``systems/``), and for each per-layer
metric that ``BENCHMARK.json`` gives the cell, ``metrics/<metric>.py``.

A training cell (``traffic.mode`` "train"): set-up builds the trainer from
the seed and drives it through its first ``compare_steps`` steps with the
window's own call and inputs (each step on another view), keeping the
losses, the first gradient as Adam got it (its first moment after one
step, over 1 - beta1) and the parameters' change over those steps; the
window then runs further steps on the same object. A relight cell
(``traffic.mode`` "relight"): set-up builds the model and renders one chunk;
the window renders chunks of ``chunk`` views, each copied to the host as
the relight evaluation does. Once the window has closed and the program's
state is freed, the reference (``reference/plain``, the same system module over the
frozen copy) works the compared steps or a sampled chunk out again from the
seed, and ``compare.py`` decides ``correct``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import compare, opcount, roofline, traffic as tr
from .systems.common import PROGRAM, REFERENCE, package

HERE = Path(__file__).resolve().parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "geosplatting_tpu")


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def spec() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def cell(name: str, config_overrides: dict | None = None,
         traffic_overrides: dict | None = None) -> dict:
    """A cell's workload, configuration and system module, from their files."""
    work = load("workloads", name)
    cfg = {**load("configs", work["config"]), **(config_overrides or {})}
    traffic = {**work["traffic"], **(traffic_overrides or {})}
    system = importlib.import_module(f"{__package__}.systems.{cfg['system']}")
    return {"name": name, "work": work, "cfg": cfg, "traffic": traffic, "system": system}


def layer_metrics(name: str, moves: set[str]) -> list[dict]:
    """The per-layer metrics of ``BENCHMARK.json`` that this cell reports."""
    out = []
    for m in spec()["per_layer"]:
        if name in m.get("workloads", [name] if m["moves"] in moves else []):
            out.append(m)
    return out


def read_metric(metric: str, ctx: dict):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def banned_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


class Capture:
    """The inputs of the last call of K1's and K2's compositing passes in
    the program, for the kernel rooflines: wraps the module functions of
    ``ops/rasterize_pairs`` while it is open."""

    def __init__(self):
        self.fwd = self.bwd = None

    def __enter__(self):
        rp = importlib.import_module(f"{PROGRAM}.ops.rasterize_pairs")
        self.rp, self.orig = rp, (rp.composite_fwd, rp.composite_bwd)
        fwd0, bwd0 = self.orig

        def fwd(pairs, seg_start, grid, channels, chunks, prod):
            out = fwd0(pairs, seg_start, grid, channels, chunks, prod)
            self.fwd = (pairs, seg_start, grid, channels, out[2])
            return out

        def bwd(pairs, seg_start, grid, channels, grad_out, t_final, n_contrib, max_pairs,
                chunks, prod, suffix):
            self.bwd = (pairs, seg_start, grid, channels, n_contrib)
            return bwd0(pairs, seg_start, grid, channels, grad_out, t_final, n_contrib,
                        max_pairs, chunks, prod, suffix)

        rp.composite_fwd, rp.composite_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.rp.composite_fwd, self.rp.composite_bwd = self.orig

    def work(self) -> dict:
        """Each captured pass's bytes, operations and bound."""
        out = {}
        for kind, names in (("fwd", roofline.K1), ("bwd", roofline.K2)):
            got = getattr(self, kind)
            if got is None:
                continue
            pairs, seg_start, grid, channels, n_contrib = got
            w = roofline.pass_work(pairs, seg_start, grid, channels, n_contrib, pairs.shape[0])
            out.update({k: w[k] for k in names})
            out[f"{kind}_counts"] = w["counts"]
        self.fwd = self.bwd = None
        return out


# ---- training ------------------------------------------------------------------


def leaves(trainer) -> dict[str, torch.Tensor]:
    return dict(trainer.model.named_parameters())


def first_grad_norms(trainer) -> dict[str, float]:
    """Each leaf's first gradient as Adam got it: its first moment after one
    update over (1 - beta1)."""
    adam = trainer.optimizers.adam
    out = {}
    beta = {id(p): g["betas"][0] for g in adam.param_groups for p in g["params"]}
    for name, p in leaves(trainer).items():
        st = adam.state.get(p)
        if st is None or "exp_avg" not in st:
            out[name] = 0.0
            continue
        out[name] = float(torch.linalg.vector_norm(st["exp_avg"].double())) / (1 - beta[id(p)])
    return out


class TrainRun:
    """A trainer driven through the traffic's steps from one package."""

    def __init__(self, c: dict, pkg, seed: int, device):
        self.c, self.pkg, self.seed, self.device = c, pkg, seed, device
        b, cfg, t = c["system"], c["cfg"], c["traffic"]
        self.trainer = b.build(pkg, cfg, tr.generator(device, seed, 0, tr.SALT_WEIGHTS), device)
        self.shapes = b.shapes(package(REFERENCE), cfg, t)
        if self.shapes["jitter"] is None:
            self.shapes["jitter"] = b.jitter_shape(self.trainer)
        self.cams = tr.orbit(pkg, t, device)
        self.order = tr.view_order(t, seed)

    def step(self, k: int, gt_all: torch.Tensor) -> dict:
        """Step ``k`` on its views; ``gt_all`` holds every view's ground truth."""
        t = self.c["traffic"]
        views = tr.step_views(t, self.order, k)
        inputs = tr.step_inputs(t, self.seed, k, self.shapes, self.device)
        return self.c["system"].train_step(self.pkg, self.trainer, self.cams[views],
                                            gt_all[views], k, inputs)

    def compared_steps(self, gt_all: torch.Tensor, control: bool = False) -> dict:
        """The first ``compare_steps`` steps and what is compared of them:
        each step's loss, the first gradient, the parameters' change, and
        the first step's rendered rgba (its forward, before any update)."""
        params0 = {k: v.detach().clone() for k, v in leaves(self.trainer).items()}
        model = self.trainer.model
        render, image = model.render, []

        def capture(*args, **kw):
            out = render(*args, **kw)
            if not image:
                image.append(out[0].detach().float().cpu())
            return out

        model.render = capture   # the instance's attribute, for step 0 only
        losses, grads, bad = [], None, 0
        for k in range(self.c["traffic"]["compare_steps"]):
            if control:
                compare.lower_precision()
            m = self.step(k, gt_all)
            losses.append(float(m["loss"]))
            bad += int(m["nonfinite_grads"]) != 0
            if k == 0:
                grads = first_grad_norms(self.trainer)
                del model.render
        change = {k: float(torch.linalg.vector_norm((v.detach() - params0[k]).double()))
                  for k, v in leaves(self.trainer).items()}
        del params0
        return {"losses": losses, "grads": grads, "change": change, "nonfinite_steps": bad,
                "image": image[0]}


def run_train(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    t, b = c["traffic"], c["system"]
    run = TrainRun(c, package(PROGRAM), seed, device)
    gt_all = tr.ground_truth(tr.orbit(package(REFERENCE), t, device), list(range(t["views"])))
    head = run.compared_steps(gt_all)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    k, times, failed, points = t["compare_steps"], [], 0, []
    prof = capture = None
    if trace:
        prof, capture = start_trace()
    w0 = time.perf_counter()
    while True:
        m = run.step(k, gt_all)
        bad = int(m["nonfinite_grads"]) != 0 or any(v > 1.0 for v in b.fills(m).values())
        failed += t["batch"] * bad
        points.append(b.shaded_points(m, c["cfg"], t))
        sync(device)
        times.append(time.perf_counter())
        k += 1
        if times[-1] - w0 >= seconds:
            break
    window_s = times[-1] - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    steps = len(times)
    views = steps * t["batch"]
    result = {"setup_s": setup_s, "window_s": window_s, "steps": steps, "views": views,
              "failed": failed, "peak": peak,
              "step_s": [b2 - a2 for a2, b2 in zip([w0] + times[:-1], times)]}
    if trace:
        work = dict(b.work(run.trainer, m, c["cfg"], t), shaded_points=sum(points) / len(points))
        result["trace_ctx"] = finish_trace(prof, capture, window_s, steps, views, work, True)
    del run, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = TrainRun(c, package(REFERENCE), seed, device).compared_steps(gt_all)
    del gt_all
    result["checks"] = compare.train_checks(head, ref, c["work"]["limits"])
    return result


# ---- relight -----------------------------------------------------------------------


def run_relight(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    t, b, cfg = c["traffic"], c["system"], c["cfg"]
    pkg = package(PROGRAM)
    shapes = b.shapes(package(REFERENCE), cfg, t)
    model = b.build_model(pkg, cfg, tr.generator(device, seed, 0, tr.SALT_WEIGHTS), device)
    cams = tr.orbit(pkg, t, device)
    order = tr.view_order(t, seed)
    scene = tr.relight_scene(t, seed, device)

    def chunk(i: int):
        views = tr.chunk_views(t, order, i)
        draws = tr.chunk_draws(t, seed, i, shapes, device)
        img, aux = b.relight(pkg, model, cams[views], draws, scene)
        return img.cpu(), aux

    chunk(0)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    prof = capture = None
    if trace:
        prof, capture = start_trace()
    outputs, failed, i, times = {}, 0, 1, []
    w0 = time.perf_counter()
    while True:
        img, aux = chunk(i)
        outputs[i] = img
        failed += t["chunk"] * any(v > 1.0 for v in b.render_fills(aux).values())
        i += 1
        times.append(time.perf_counter())
        if times[-1] - w0 >= seconds:
            break
    window_s = times[-1] - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    chunks = len(outputs)
    views = chunks * t["chunk"]
    result = {"setup_s": setup_s, "window_s": window_s, "steps": chunks, "views": views,
              "failed": failed, "peak": peak,
              "step_s": [b2 - a2 for a2, b2 in zip([w0] + times[:-1], times)]}
    if trace:
        work = dict(b.render_work(model, cfg, t), shaded_points=float(t["resolution"] ** 2))
        result["trace_ctx"] = finish_trace(prof, capture, window_s, chunks, views, work, False)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(tr.subseed(seed, 0, tr.SALT_SAMPLE))
    picks = torch.randperm(chunks, generator=g)[:t["compare_chunks"]].add(1).tolist()
    ref_model = b.build_model(package(REFERENCE), cfg,
                              tr.generator(device, seed, 0, tr.SALT_WEIGHTS), device)
    ref_cams = tr.orbit(package(REFERENCE), t, device)
    gaps = []
    for i in picks:
        views = tr.chunk_views(t, order, i)
        draws = tr.chunk_draws(t, seed, i, shapes, device)
        want, _ = b.relight(package(REFERENCE), ref_model, ref_cams[views], draws, scene)
        gaps.append(compare.image_gaps(outputs[i], want.cpu()))
    result["checks"] = compare.relight_checks(gaps, c["work"]["limits"])
    return result


# ---- tracing -------------------------------------------------------------------------


def start_trace():
    from torch.profiler import ProfilerActivity, profile

    capture = Capture().__enter__()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof, capture


def finish_trace(prof, capture, window_s: float, steps: int, views: int, work: dict,
                 training: bool) -> dict:
    from .trace import Trace

    prof.__exit__(None, None, None)
    capture.__exit__(None, None, None)
    passes = capture.work()
    work = dict(work,
                k1_ops=sum(passes[k]["ops"] for k in roofline.K1 if k in passes),
                k2_ops=sum(passes[k]["ops"] for k in roofline.K2 if k in passes))
    trace = Trace.from_profiler(prof, window_s)
    del prof
    return {"trace": trace, "passes": passes, "steps": steps, "views": views,
            "view_ops": opcount.view_ops(work, training)}


# ---- the result ------------------------------------------------------------------------


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float, *,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Runs the cell once and returns the result line's object (the compared
    numbers with their limits under ``checks``, last)."""
    c = cell(name, config_overrides, traffic_overrides)
    mode = c["traffic"]["mode"]
    run = {"train": run_train, "relight": run_relight}[mode]
    r = run(c, seed, seconds, trace, device, t_start)
    ends = {m["name"] for m in spec()["end_to_end"]}
    metrics = {}
    if not trace:
        values = {"views_per_s": (r["views"] / r["window_s"], "views/s"),
                  "peak_mem_gib": (r["peak"] / 2**30, "GiB"),
                  "setup_s": (r["setup_s"], "s")}
        for m in spec()["end_to_end"]:
            if name in m.get("workloads", [name]) and m["name"] in values:
                v, unit = values[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        ctx = r["trace_ctx"]
        for m in layer_metrics(name, ends):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = r["checks"]
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(r["peak"])}
    out = {"correct": all(v["ok"] for v in checks.values()) and r["failed"] == 0,
           "attempted": r["views"], "failed": r["failed"], "metrics": metrics,
           "device": device_info}
    if trace:
        t = r["trace_ctx"]["trace"]
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    out["step_s"] = r["step_s"]   # each whole step's or chunk's seconds in the window
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return out
