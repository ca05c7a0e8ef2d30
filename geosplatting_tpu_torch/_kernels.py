"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled into its own shared library with a
plain C interface, loaded with ``ctypes``; the ``nvcc`` calls for all
sources start together and run in parallel. The build happens at first use,
into ``_build/`` beside this file, under names derived from the sources'
content, so an edited source rebuilds and an unchanged one is reused.
Nothing here runs at import time.

Each kernel wrapper adds one to ``launches[<kernel>]`` right after it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels; ``launches`` is the counter registry's
(``counters``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .counters import launches

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the rasterizer's kernels (K1-K3), launched for every camera rendered
RASTER_KERNELS = ("k1_chunk_products", "k1_composite_fwd", "k2_chunk_suffix",
                  "k2_composite_bwd", "k3_cumsum_rows")
# K4, the shading's SDF sphere trace, and K5, its Monte-Carlo loop
KERNELS = (*RASTER_KERNELS, "sdf_trace", "mc_shade_fwd", "mc_shade_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # pairs, seg_start, chunk_tile, tile_chunk_start, num_tiles, num_slots,
    # tw, tsx, tsy, channels, kc, then each kernel's own operands, stream
    "k1_chunk_products": (_I, [_P, _P, _P, _P, *[_I] * 7, _P, _P]),
    "k1_composite_fwd": (_I, [_P, _P, _P, _P, *[_I] * 7, *[_P] * 8]),
    "k2_chunk_suffix": (_I, [_P, _P, _P, _P, *[_I] * 7, *[_P] * 5]),
    "k2_composite_bwd": (_I, [_P, _P, _P, _P, *[_I] * 7, *[_P] * 6, _L, _P]),
    "k3_cumsum_rows": (_I, [_P, _P, _P, _L, _I, _P]),
    "k3_scratch_floats": (_L, [_L, _I]),
    # origins, dirs, cells, out, counts, num_rays, rx, ry, rz, scale, inv_scale,
    # t_start, t_max, min_step, softness, num_steps, stream
    "sdf_trace": (_I, [*[_P] * 5, _L, *[_I] * 3, *[ctypes.c_float] * 6, _I, _P]),
    # kd, arm, nrm, wo, bank_cols, light_rows, the 8 sample arrays, then the
    # forward's 3 outputs, or the backward's 3 upstream gradients and 6
    # gradients; n, steps, mode, frac, third, exponent (the backward: bank
    # rows), stream
    "mc_shade_fwd": (_I, [*[_P] * 17, _L, _I, _I, *[ctypes.c_float] * 3, _P]),
    "mc_shade_bwd": (_I, [*[_P] * 23, _L, _I, _I, *[ctypes.c_float] * 3, _I, _P]),
    "geosplat_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_library: dict | None = None


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry-point device: CUDA unless the caller asks for another device.
    Raises when CUDA is asked for (or defaulted to) and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build() -> tuple[list[Path], str]:
    """Compile the kernels whose content has not been built yet, one ``nvcc``
    process per source, all started together. Returns (library paths, the
    compilers' output including ``-Xptxas -v``)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SOURCE_DIR.glob("*.cuh")):  # every source includes the headers
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    libs, procs = [], []
    for src in sorted(SOURCE_DIR.glob("*.cu")):
        d = digest.copy()
        d.update(src.read_bytes())
        lib = BUILD_DIR / f"lib{src.stem}_{d.hexdigest()[:16]}.so"
        libs.append(lib)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = [lib.with_suffix(".log") for lib in libs]
    return libs, "".join(log.read_text() for log in logs if log.exists())


def library() -> dict[str, ctypes._CFuncPtr]:
    """The kernels' C entry points by name, typed (builds at first use)."""
    global _library
    with _lock:
        if _library is None:
            paths, _ = build()
            loaded = [ctypes.CDLL(str(path)) for path in paths]
            entry = {}
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = next(getattr(lib, name) for lib in loaded if hasattr(lib, name))
                fn.restype = restype
                fn.argtypes = argtypes
                entry[name] = fn
            _library = entry
    return _library


def launch(name: str, *args) -> None:
    """Call kernel entry point ``name`` and count the launch; raises on a
    non-zero CUDA status (a refused launch never runs, so it must be
    checked right here)."""
    lib = library()
    status = lib[name](*args)
    if status != 0:
        msg = lib["geosplat_error_string"](status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
    launches[name] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      shape: tuple | None = None) -> None:
    """Validate a kernel operand before its pointer is handed to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
