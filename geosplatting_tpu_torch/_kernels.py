"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ONE ``nvcc`` call into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``_build/`` beside this file, under a name derived from
the sources' content, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time.

Each kernel wrapper adds one to ``launches[<kernel>]`` right after it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("k1_composite_fwd", "k2_composite_bwd", "k3_cumsum_rows")
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "k1_composite_fwd": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "k2_composite_bwd": (
        _I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P]
    ),
    "k3_cumsum_rows": (_I, [_P, _P, _P, _L, _I, _P]),
    "k3_scratch_floats": (_L, [_L, _I]),
    "geosplat_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


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


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def build() -> tuple[Path, str]:
    """Compile the kernels if this content has not been built yet. Returns
    (library path, the compiler's output including ``-Xptxas -v``)."""
    files = sorted(SOURCE_DIR.glob("*.cu*"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib = BUILD_DIR / f"libgeosplat_kernels_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _library = lib
    return _library


def launch(name: str, *args) -> None:
    """Call kernel entry point ``name`` and count the launch; raises on a
    non-zero CUDA status (a refused launch never runs, so it must be
    checked right here)."""
    lib = library()
    status = getattr(lib, name)(*args)
    if status != 0:
        msg = lib.geosplat_error_string(status).decode()
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
