"""Offline animation compositor: a declarative layout tree rendered per frame.

Counterpart of ``geosplatting_tpu/visualization/director.py``: the
``render_frame(idx, size) -> image`` protocol composed through grid
containers, static images, text and colours, fades, crop-highlight insets
and image-sequence leaves; ``Director.write`` streams the frames into
``data/io.open_video_renderer``. Host-side numpy / Pillow code: a frame
given as a tensor (a model's render) is moved to the host first.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np


class Animatable(Protocol):
    def num_frames(self) -> int: ...
    def render_frame(self, idx: int, size: tuple[int, int]) -> np.ndarray: ...


def _host(x) -> np.ndarray:
    """A numpy array; a tensor is detached and moved to the host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    w, h = size
    if img.shape[1] == w and img.shape[0] == h:
        return img
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h), Image.BILINEAR)).astype(np.float32) / 255


@dataclasses.dataclass
class Leaf:
    """Image-sequence leaf ([T, H, W, 3] floats or a list of frames); the
    last frame holds, or with ``hold=False`` the sequence loops."""

    frames: Sequence[np.ndarray]
    hold: bool = True

    def num_frames(self) -> int:
        return len(self.frames)

    def render_frame(self, idx: int, size):
        i = min(idx, len(self.frames) - 1) if self.hold else idx % len(self.frames)
        return _resize(_host(self.frames[i])[..., :3], size)


@dataclasses.dataclass
class Static:
    """A single image or a constant colour."""

    image: np.ndarray | tuple = (1.0, 1.0, 1.0)

    def num_frames(self) -> int:
        return 1

    def render_frame(self, idx: int, size):
        w, h = size
        img = _host(self.image).astype(np.float32)
        if img.ndim == 1:
            return np.broadcast_to(img, (h, w, 3)).copy()
        return _resize(img[..., :3], size)


@dataclasses.dataclass
class Text:
    """A label in Pillow's default font, centred."""

    text: str
    color: tuple = (0.0, 0.0, 0.0)
    background: tuple = (1.0, 1.0, 1.0)

    def num_frames(self) -> int:
        return 1

    def render_frame(self, idx: int, size):
        from PIL import Image, ImageDraw

        w, h = size
        img = Image.new(
            "RGB", (w, h),
            tuple(int(c * 255) for c in self.background),
        )
        d = ImageDraw.Draw(img)
        bbox = d.textbbox((0, 0), self.text)
        d.text(
            ((w - bbox[2]) // 2, (h - bbox[3]) // 2), self.text,
            fill=tuple(int(c * 255) for c in self.color),
        )
        return np.asarray(img).astype(np.float32) / 255


@dataclasses.dataclass
class Fade:
    """Fade in or out: a linear blend with ``to`` over ``duration`` frames
    at the start (mode 'in') or the end (mode 'out')."""

    content: Animatable
    duration: int = 24
    mode: str = "in"
    to: tuple = (1.0, 1.0, 1.0)

    def num_frames(self) -> int:
        return self.content.num_frames()

    def render_frame(self, idx: int, size):
        img = self.content.render_frame(idx, size)
        n = self.num_frames()
        if self.mode == "in":
            a = np.clip(idx / max(self.duration, 1), 0.0, 1.0)
        else:
            a = np.clip((n - 1 - idx) / max(self.duration, 1), 0.0, 1.0)
        return img * a + np.asarray(self.to, np.float32) * (1 - a)


@dataclasses.dataclass
class Highlight:
    """Crop-zoom inset: a rectangle drawn on the content and the crop,
    magnified, in its bottom-right corner."""

    content: Animatable
    crop: tuple  # (x0, y0, x1, y1) in [0, 1] relative coords
    zoom: float = 2.5
    color: tuple = (1.0, 0.1, 0.1)

    def num_frames(self) -> int:
        return self.content.num_frames()

    def render_frame(self, idx: int, size):
        img = self.content.render_frame(idx, size).copy()
        h, w = img.shape[:2]
        x0, y0, x1, y1 = self.crop
        px0, py0, px1, py1 = (
            int(x0 * w), int(y0 * h), int(x1 * w), int(y1 * h)
        )
        c = np.asarray(self.color, np.float32)
        img[py0:py1, px0:px0 + 2] = c
        img[py0:py1, px1 - 2:px1] = c
        img[py0:py0 + 2, px0:px1] = c
        img[py1 - 2:py1, px0:px1] = c
        crop = img[py0 + 2:py1 - 2, px0 + 2:px1 - 2]
        cw = int((px1 - px0) * self.zoom)
        ch = int((py1 - py0) * self.zoom)
        cw, ch = min(cw, w - 4), min(ch, h - 4)
        inset = _resize(crop, (cw, ch))
        img[h - ch - 2:h - 2, w - cw - 2:w - 2] = inset
        img[h - ch - 4:h - ch - 2, w - cw - 4:w - 2] = c
        img[h - 4:h - 2, w - cw - 4:w - 2] = c
        img[h - ch - 4:h - 2, w - cw - 4:w - cw - 2] = c
        img[h - ch - 4:h - 2, w - 4:w - 2] = c
        return img


@dataclasses.dataclass
class Grid:
    """Row-major grid container."""

    children: Sequence[Sequence[Animatable | None]]
    cell: tuple[int, int] = (400, 400)
    gap: int = 4
    background: tuple = (1.0, 1.0, 1.0)

    def num_frames(self) -> int:
        return max(
            c.num_frames()
            for row in self.children for c in row if c is not None
        )

    def render_frame(self, idx: int, size=None):
        rows = len(self.children)
        cols = max(len(r) for r in self.children)
        cw, ch = self.cell
        w = cols * cw + (cols + 1) * self.gap
        h = rows * ch + (rows + 1) * self.gap
        canvas = np.broadcast_to(
            np.asarray(self.background, np.float32), (h, w, 3)
        ).copy()
        for i, row in enumerate(self.children):
            for j, child in enumerate(row):
                if child is None:
                    continue
                y = self.gap + i * (ch + self.gap)
                x = self.gap + j * (cw + self.gap)
                canvas[y:y + ch, x:x + cw] = child.render_frame(idx, (cw, ch))
        if size is not None:
            canvas = _resize(canvas, size)
        return canvas


@dataclasses.dataclass
class Director:
    """Renders a layout tree into frames and writes them out."""

    root: Animatable
    fps: int = 24

    def frames(self):
        for idx in range(self.root.num_frames()):
            yield self.root.render_frame(idx, None)

    def write(self, path) -> None:
        from ..data.io import open_video_renderer

        with open_video_renderer(path, fps=self.fps) as put:
            for frame in self.frames():
                put(frame)
