"""Paper-figure helpers: labelled image grids with crop-zoom highlights.

Counterpart of ``geosplatting_tpu/visualization/figures.py``: comparison
grids with row and column labels and magnified crops, host-side numpy /
Pillow code; images given as tensors are moved to the host.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .director import _host


def highlight_crop(
    img: np.ndarray,
    crop: tuple,                 # (x0, y0, x1, y1) relative [0, 1]
    *,
    color: tuple = (1.0, 0.1, 0.1),
    border: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (image with rectangle drawn, the cropped region)."""
    img = _host(img).astype(np.float32)[..., :3].copy()
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (
        int(crop[0] * w), int(crop[1] * h), int(crop[2] * w), int(crop[3] * h)
    )
    region = img[y0:y1, x0:x1].copy()
    c = np.asarray(color, np.float32)
    img[y0:y1, x0:x0 + border] = c
    img[y0:y1, x1 - border:x1] = c
    img[y0:y0 + border, x0:x1] = c
    img[y1 - border:y1, x0:x1] = c
    return img, region


@dataclasses.dataclass
class TabularFigures:
    """Comparison grid: ``rows`` maps row label -> {col label -> image}."""

    rows: dict
    cell: tuple[int, int] = (256, 256)
    gap: int = 6
    label_height: int = 20
    label_width: int = 90
    crop: tuple | None = None    # optional highlight crop applied to every cell
    zoom_row: bool = True        # append a zoomed-crop row per column

    def render(self) -> np.ndarray:
        from PIL import Image, ImageDraw

        col_names: list = []
        for cells in self.rows.values():
            for c in cells:
                if c not in col_names:
                    col_names.append(c)
        row_names = list(self.rows)
        cw, ch = self.cell
        n_rows = len(row_names)
        w = self.label_width + len(col_names) * (cw + self.gap) + self.gap
        h = self.label_height + n_rows * (ch + self.gap) + self.gap
        if self.crop is not None and self.zoom_row:
            h += n_rows * (ch + self.gap)
        canvas = Image.new("RGB", (w, h), (255, 255, 255))
        draw = ImageDraw.Draw(canvas)

        for j, cn in enumerate(col_names):
            x = self.label_width + self.gap + j * (cw + self.gap)
            draw.text((x + cw // 2 - 4 * len(cn) // 2, 4), cn, fill=(0, 0, 0))
        y = self.label_height + self.gap
        for rn in row_names:
            draw.text((4, y + ch // 2), rn, fill=(0, 0, 0))
            for j, cn in enumerate(col_names):
                img = self.rows[rn].get(cn)
                if img is None:
                    continue
                img = _host(img).astype(np.float32)[..., :3]
                region = None
                if self.crop is not None:
                    img, region = highlight_crop(img, self.crop)
                pil = Image.fromarray(
                    (np.clip(img, 0, 1) * 255).astype(np.uint8)
                ).resize((cw, ch), Image.BILINEAR)
                x = self.label_width + self.gap + j * (cw + self.gap)
                canvas.paste(pil, (x, y))
                if region is not None and self.zoom_row:
                    zoom = Image.fromarray(
                        (np.clip(region, 0, 1) * 255).astype(np.uint8)
                    ).resize((cw, ch), Image.NEAREST)
                    canvas.paste(zoom, (x, y + n_rows * (ch + self.gap)))
            y += ch + self.gap
        return np.asarray(canvas).astype(np.float32) / 255

    def save(self, path: Path | str) -> None:
        from ..data.io import dump_float32_image

        dump_float32_image(path, self.render())
