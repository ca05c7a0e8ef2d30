"""Host-side image IO for PNG and the other formats Pillow reads.

Counterpart of ``geosplatting_tpu/data/io.py`` (``load_float32_image``,
``load_masked_image``, ``dump_float32_image``, ``resize_image``) for the LDR
formats: images are float32 numpy arrays [H, W, C] in [0, 1], as stored
(sRGB-encoded). Pillow is imported inside each function. HDR formats (EXR,
Radiance HDR) and video are not ported yet: the JAX package reads them
through ``cv2`` or ``imageio``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

LDR_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif", ".webp")


def load_float32_image(path: Path | str) -> np.ndarray:
    """[H, W, C] float32 in [0, 1] (8- and 16-bit images scaled by their
    maximum)."""
    from PIL import Image

    path = Path(path)
    if path.suffix.lower() not in LDR_SUFFIXES:
        raise ValueError(f"unsupported image format (HDR formats are not ported yet): {path}")
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
    """Writes [H, W, C] (C = 1, 3 or 4) values in [0, 1] as 8 bits."""
    from PIL import Image

    path = Path(path)
    if path.suffix.lower() not in (".png", ".jpg", ".jpeg", ".bmp", ".webp"):
        raise ValueError(f"unsupported image format (HDR formats are not ported yet): {path}")
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
