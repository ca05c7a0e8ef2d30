"""The PyTorch port stands alone: no module of ``geosplatting_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, optax or the JAX package, and the entry
points run on CUDA unless the caller asks for the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import geosplatting_tpu_torch
from geosplatting_tpu_torch.graphics.cameras import Cameras
from geosplatting_tpu_torch.models.geosplat import GeoSplatter

from .torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["optax"] = None
import geosplatting_tpu_torch
names = [m.name for m in pkgutil.walk_packages(geosplatting_tpu_torch.__path__,
                                               "geosplatting_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "geosplatting_tpu")
                and sys.modules[m] is not None)
print(len(names), leaked)
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, leaked = proc.stdout.split(maxsplit=1)
    # every .py file but the package's own __init__ is one module imported
    files = list(Path(geosplatting_tpu_torch.__file__).parent.rglob("*.py"))
    assert int(count) == len(files) - 1
    assert leaked.strip() == "[]"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeoSplatter(resolution=4, light_resolution=16, triplane_resolution=8)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_orbit_cameras_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                           num_samples=3)


def test_orbit_cameras_on_the_cpu_when_asked():
    cams = Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=2.0, elevation_degrees=15.0,
                              num_samples=3, width=32, height=24, device="cpu")
    assert cams.c2w.device.type == "cpu" and cams.c2w.shape == (3, 3, 4)
    # every camera sits on the orbit and looks at its center
    eye = cams.camera_pos
    torch.testing.assert_close(eye.norm(dim=-1), torch.full((3,), 2.0))
    torch.testing.assert_close(cams.c2w[:, :3, 2], eye / 2.0)
