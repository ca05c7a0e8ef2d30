"""On-disk stage hand-offs (counterpart of
``geosplatting_tpu/engine/stage_io.py``): each stage's train task writes its
export, the next stage's ``--load`` reads it.

An export is a (possibly nested) dict of tensors, arrays and scalars, stored
as one ``.npz`` with '/'-joined keys; ``None`` leaves are stored as the
string ``__none__`` and an empty dict as a ``<key>/__none__`` marker, so the
files of the two packages read the same in either."""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

_NONE = "__none__"


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            if not v:
                yield f"{key}/{_NONE}", np.asarray(0)
            yield from _flatten(v, f"{key}/")
        elif v is None:
            yield key, np.asarray(_NONE)
        else:
            yield key, _leaf(v)


def save_export(path: Path, export: dict[str, Any]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **dict(_flatten(export)))
    return path


def load_export(path: Path) -> dict[str, Any]:
    """The nested dict of numpy arrays (and None / str leaves) of an export
    file or of a run directory's ``export.npz``."""
    path = Path(path)
    if path.is_dir():
        path = path / "export.npz"
    data = np.load(path, allow_pickle=False)
    out: dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == _NONE:
            continue  # empty-dict marker: the dict node already exists
        leaf = data[key]
        if leaf.dtype.kind in ("U", "S") and leaf.shape == ():
            node[parts[-1]] = None if str(leaf) == _NONE else str(leaf)
        else:
            node[parts[-1]] = leaf
    return out


def find_export(output_dir: Path) -> Path:
    """Locate the export file for a run directory (or a direct file path)."""
    p = Path(output_dir)
    if p.is_file():
        return p
    for cand in (p / "export.npz", p / "export" / "export.npz"):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"no export.npz under {p} — run the previous stage's task first")
