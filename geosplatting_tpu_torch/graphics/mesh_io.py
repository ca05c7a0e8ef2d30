"""Host-side triangle-mesh file IO: OBJ and PLY (ascii and
binary_little_endian).

Counterpart of ``geosplatting_tpu/graphics/mesh_io.py``, numpy only: the
mesh-prior input (``--mesh_path``) and mesh exports. Quads and larger
polygons are fan-triangulated; vertex colours, normals and uvs are returned
when present. ``save_mesh`` writes OBJ (1-based faces, optional vertex
colours) or binary little-endian PLY (float xyz, optional uchar rgb, uchar
count + int32 indices per face).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_mesh(path: Path | str) -> dict:
    """Returns dict with 'vertices' [V,3] f32, 'indices' [F,3] i32 and, when
    present, 'colors' [V,3], 'normals' [V,3], 'uvs' [V,2]."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return _load_obj(path)
    if suffix == ".ply":
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def save_mesh(path: Path | str, vertices: np.ndarray, indices: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        with open(path, "w") as f:
            for i, v in enumerate(np.asarray(vertices)):
                if colors is not None:
                    c = np.asarray(colors)[i]
                    f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
                else:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in np.asarray(indices):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
        return
    if suffix == ".ply":
        _save_ply(path, vertices, indices, colors)
        return
    raise ValueError(f"unsupported mesh format: {path}")


def _load_obj(path: Path) -> dict:
    verts: list = []
    colors: list = []
    normals: list = []
    uvs: list = []
    faces: list = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) for i in idx]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    out = {
        "vertices": np.asarray(verts, np.float32),
        "indices": np.asarray(faces, np.int32).reshape(-1, 3),
    }
    if colors and len(colors) == len(verts):
        out["colors"] = np.asarray(colors, np.float32)
    if normals and len(normals) == len(verts):
        out["normals"] = np.asarray(normals, np.float32)
    if uvs and len(uvs) == len(verts):
        out["uvs"] = np.asarray(uvs, np.float32)
    return out


def _load_ply(path: Path) -> dict:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements: list[tuple[str, int, list]] = []  # (name, count, props)
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
        out: dict = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[2] for p in props]
                    arr = np.asarray(rows, np.float64)
                    out.update(_vertex_fields(arr, names))
                elif name == "face":
                    faces = []
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1:1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                    out["indices"] = np.asarray(faces, np.int32).reshape(-1, 3)
            elif fmt == "binary_little_endian":
                if name == "vertex":
                    names = [p[2] for p in props]
                    dtype = np.dtype(
                        [(p[2], "<" + _PLY_DTYPES[p[1]]) for p in props]
                    )
                    data = np.frombuffer(f.read(dtype.itemsize * count), dtype)
                    arr = np.stack(
                        [data[n].astype(np.float64) for n in names], axis=-1
                    )
                    out.update(_vertex_fields(arr, names))
                elif name == "face":
                    assert props[0][0] == "list"
                    cnt_dt = "<" + _PLY_DTYPES[props[0][1]]
                    idx_dt = "<" + _PLY_DTYPES[props[0][2]]
                    cnt_sz = np.dtype(cnt_dt).itemsize
                    idx_sz = np.dtype(idx_dt).itemsize
                    faces = []
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_sz), cnt_dt)[0])
                        idx = np.frombuffer(f.read(idx_sz * n), idx_dt)
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                    out["indices"] = np.asarray(faces, np.int32).reshape(-1, 3)
            else:
                raise ValueError(f"unsupported ply format: {fmt}")
    return out


def _vertex_fields(arr: np.ndarray, names: list) -> dict:
    cols = {n: i for i, n in enumerate(names)}
    out = {
        "vertices": np.stack(
            [arr[:, cols[c]] for c in ("x", "y", "z")], -1
        ).astype(np.float32)
    }
    if all(c in cols for c in ("red", "green", "blue")):
        rgb = np.stack([arr[:, cols[c]] for c in ("red", "green", "blue")], -1)
        out["colors"] = (rgb / 255.0 if rgb.max() > 1.0 else rgb).astype(np.float32)
    if all(c in cols for c in ("nx", "ny", "nz")):
        out["normals"] = np.stack(
            [arr[:, cols[c]] for c in ("nx", "ny", "nz")], -1
        ).astype(np.float32)
    return out


def _save_ply(path: Path, vertices, indices, colors=None) -> None:
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(indices)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            for v, c in zip(vertices, c8):
                f.write(struct.pack("<fff", *v) + struct.pack("<BBB", *c))
        else:
            f.write(vertices.astype("<f4").tobytes())
        counts = np.full((len(indices), 1), 3, np.uint8)
        body = b"".join(
            counts[i].tobytes() + indices[i].astype("<i4").tobytes()
            for i in range(len(indices))
        )
        f.write(body)
