"""Host-side image IO: PNG and the other formats Pillow reads, and the HDR
formats (OpenEXR, Radiance HDR) through OpenCV.

Counterpart of ``geosplatting_tpu/data/io.py`` (``load_float32_image``,
``load_masked_image``, ``dump_float32_image``, ``resize_image``). LDR images
are float32 numpy arrays [H, W, C] in [0, 1], as stored (sRGB-encoded); HDR
images are float32 linear radiance, RGB(A) in that order. Pillow and ``cv2``
are imported inside each function. The JAX package's ``imageio`` fallback
is not ported: an HDR file ``cv2`` cannot decode raises. OpenCV builds
decode OpenEXR only with ``OPENCV_IO_ENABLE_OPENEXR=1`` in the environment
before ``cv2`` is imported, and some builds carry no EXR codec at all; the
error names both. ``open_video_renderer`` writes frames as a GIF (Pillow),
a video through ``imageio`` where it imports, or else a PNG sequence.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

LDR_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif", ".webp")
HDR_SUFFIXES = (".exr", ".hdr")


def _hdr_error(path: Path, action: str) -> ValueError:
    hint = ""
    if path.suffix.lower() == ".exr":
        hint = (" (OpenCV decodes OpenEXR only with OPENCV_IO_ENABLE_OPENEXR=1 set before cv2 "
                "is imported, and some builds have no EXR codec)")
    return ValueError(f"cv2 could not {action} the HDR image {path}{hint}")


def _swap_rb(img: np.ndarray) -> np.ndarray:
    """BGR(A) <-> RGB(A) on the last axis (cv2's channel order)."""
    if img.ndim == 3 and img.shape[-1] >= 3:
        return img[..., [2, 1, 0] + list(range(3, img.shape[-1]))]
    return img


def load_float32_image(path: Path | str) -> np.ndarray:
    """[H, W, C] float32: LDR formats in [0, 1] (8- and 16-bit images scaled
    by their maximum, sRGB-encoded values as stored), HDR formats in linear
    radiance."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in HDR_SUFFIXES:
        import cv2

        if not path.exists():
            raise FileNotFoundError(path)
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise _hdr_error(path, "decode")
        img = _swap_rb(np.asarray(img).astype(np.float32))
        return img[..., None] if img.ndim == 2 else img
    if suffix not in LDR_SUFFIXES:
        raise ValueError(f"unsupported image format: {path}")
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    return img


def load_masked_image(image_path: Path | str, mask_path: Path | str | None = None) -> np.ndarray:
    """RGBA [H, W, 4]: alpha from the image itself or a separate mask file."""
    img = load_float32_image(image_path)
    if mask_path is not None:
        mask = load_float32_image(mask_path)[..., :1]
        return np.concatenate((img[..., :3], mask), axis=-1)
    if img.shape[-1] == 4:
        return img
    return np.concatenate((img, np.ones_like(img[..., :1])), axis=-1)


def dump_float32_image(path: Path | str, img: np.ndarray) -> None:
    """Writes [H, W, C] (C = 1, 3 or 4): LDR formats as 8 bits of the values
    clipped to [0, 1], HDR formats as float radiance."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in HDR_SUFFIXES:
        import cv2

        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            ok = cv2.imwrite(str(path), _swap_rb(np.asarray(img, np.float32)))
        except cv2.error as e:
            raise _hdr_error(path, "encode") from e
        if not ok:
            raise _hdr_error(path, "encode")
        return
    if suffix not in (".png", ".jpg", ".jpeg", ".bmp", ".webp"):
        raise ValueError(f"unsupported image format: {path}")
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def resize_image(img: np.ndarray, scale_factor: float) -> np.ndarray:
    """Pillow's bilinear resize of an 8-bit quantisation of ``img`` to
    int(H * s) x int(W * s), back to float32 in [0, 1]."""
    from PIL import Image

    h, w = img.shape[:2]
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    out = np.asarray(pil.resize((nw, nh), Image.BILINEAR)).astype(np.float32) / 255.0
    if out.ndim == 2:
        out = out[..., None]
    return out


@contextlib.contextmanager
def open_video_renderer(path: Path | str, fps: int = 24):
    """Context manager yielding ``put(frame)`` for [H, W, 3+] float frames in
    [0, 1] (numpy, or tensors moved to the host); the frames are written
    when the block ends. By suffix: ``.gif`` through Pillow; ``.mp4``,
    ``.webm``, ``.mkv``, ``.avi`` through ``imageio`` where it imports and
    encodes, else (with a warning) a PNG sequence in the directory of the
    path without its suffix; any other path is that directory,
    ``frame_%05d.png``."""
    path = Path(path)
    frames: list[np.ndarray] = []

    def put(frame) -> None:
        if hasattr(frame, "detach"):
            frame = frame.detach().cpu().numpy()
        frame = np.asarray(frame)
        frames.append((np.clip(frame[..., :3], 0, 1) * 255).astype(np.uint8))

    yield put

    if not frames:
        return
    from PIL import Image

    suffix = path.suffix.lower()
    if suffix == ".gif":
        ims = [Image.fromarray(f) for f in frames]
        path.parent.mkdir(parents=True, exist_ok=True)
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=int(1000 / fps),
                    loop=0)
        return
    if suffix in (".mp4", ".webm", ".mkv", ".avi"):
        try:
            import imageio.v3 as iio

            path.parent.mkdir(parents=True, exist_ok=True)
            iio.imwrite(path, np.stack(frames), fps=fps)
            return
        except Exception:   # no imageio or no encoder: the PNG sequence below
            import warnings

            path = path.with_suffix("")
            warnings.warn(f"no video encoder available; writing PNG sequence to {path}/")
    path.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(path / f"frame_{i:05d}.png")
