"""Why the card's float32 antialias vertex gradient differs from the CPU's.

Runs phase 14 (e)'s antialias comparison of ``chip_smoke.py`` (the 120 x 112
UV sphere at 800x800, the same cotangent) and prints one JSON line:

- ``xy_max_diff_px``: the largest difference between the two devices'
  projected vertex positions;
- ``same_xy_grad_rel_err``: the gradient in the projected positions, both
  devices given the CPU's positions, card against CPU, over its largest
  entry (the blending alone, without the projection's rounding);
- ``midpoint_ties``: the pixel pairs whose blend weight is exactly 0 on one
  device and not on the other (the edge crosses the pair's midpoint on
  one device only), with each device's weight;
- ``float32_grad_rel_err``: the vertex gradient's error, card against CPU,
  over its largest entry, as phase 14 (e) reports it.

Needs a CUDA device: ``python3 antialias_probe.py``.
"""
import json
import sys

import torch
from torch.overrides import TorchFunctionMode

import chip_smoke
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.ops import mesh_raster as mr


class BlendWeights(TorchFunctionMode):
    """Keeps the blend weights of each pass: the clamp to [-0.5, 0.5]."""

    def __init__(self):
        super().__init__()
        self.weights = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.clamp and args[1:3] == (-0.5, 0.5):
            self.weights.append(out.detach().cpu())
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("antialias_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.device("cuda")
    cam = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                             num_samples=1, width=chip_smoke.BATCHED["stage23_image"],
                             height=chip_smoke.BATCHED["stage23_image"], device="cpu")[0]
    mesh = chip_smoke.uv_sphere(*chip_smoke.BATCHED["antialias_sphere"])
    with torch.no_grad():
        rast, _ = mr.rasterize_mesh(mesh, cam, tile_capacity=int(mesh.indices.shape[0]))
        color = (mr.interpolate(torch.clamp(mesh.vertices * 0.8 + 0.5, 0.0, 1.0), mesh, rast)
                 + (rast.tri_id < 0)[..., None] * 0.1)
    w = torch.randn(color.shape, generator=torch.Generator().manual_seed(0))
    project = mr._project_vertices
    xy_cpu = project(mesh, cam)[0].detach()

    def run(dev, xy=None):
        """(the gradient in the vertices, or in ``xy`` when given; the blend
        weights of both passes)."""
        v = mesh.vertices.detach().to(dev).clone().requires_grad_()
        leaf = None if xy is None else xy.to(dev).clone().requires_grad_()
        if leaf is not None:
            mr._project_vertices = lambda m, c: (leaf, None)
        try:
            with BlendWeights() as bw:
                out = mr.antialias(color.to(dev), TriangleMesh(vertices=v,
                                                               indices=mesh.indices.to(dev)),
                                   cam.to(dev), mr.RasterOut(*(x.to(dev) for x in rast)))
            (out * w.to(dev)).sum().backward()
        finally:
            mr._project_vertices = project
        grad = v.grad if leaf is None else leaf.grad
        return grad.cpu(), bw.weights

    g_card, w_card = run(card)
    g_cpu, w_cpu = run("cpu")
    gxy_card, _ = run(card, xy_cpu)
    gxy_cpu, _ = run("cpu", xy_cpu)
    ties = []
    for p, (a, b) in enumerate(zip(w_card, w_cpu)):
        for i, j in ((a == 0) != (b == 0)).nonzero().tolist():
            ties.append({"pass": "horizontal" if p == 0 else "vertical", "pair": [i, j],
                         "weight_card": float(a[i, j]), "weight_cpu": float(b[i, j])})
    xy_card = project(TriangleMesh(vertices=mesh.vertices.to(card),
                                   indices=mesh.indices.to(card)), cam.to(card))[0].detach().cpu()
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "xy_max_diff_px": float((xy_card - xy_cpu).abs().max()),
        "same_xy_grad_rel_err": float((gxy_card - gxy_cpu).abs().max()
                                      / gxy_cpu.abs().max()),
        "midpoint_ties": ties,
        "float32_grad_rel_err": float((g_card - g_cpu).abs().max() / g_cpu.abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
