"""Minimal PLY triangle-mesh / point-cloud IO (replaces open3d IO, eval-only).

The port's own copy of ``nerf_vo_tpu/evaluation/meshio.py`` (numpy only).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY. vertices [N,3] f32, faces [M,3] int,
    colors [N,3] uint8 or float in [0,1]."""
    n = len(vertices)
    m = 0 if faces is None else len(faces)
    has_color = colors is not None
    if has_color and colors.dtype != np.uint8:
        colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        if faces is not None:
            header += [f"element face {m}",
                       "property list uchar int vertex_indices"]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        v = np.ascontiguousarray(vertices, np.float32)
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = v
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(v.tobytes())
        if faces is not None:
            rec = np.zeros(m, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
            rec["n"] = 3
            rec["idx"] = np.ascontiguousarray(faces, np.int32)
            f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read ascii or binary-LE PLY. Returns (vertices [N,3], faces or None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header = data[:end].decode(errors="replace").split("\n")
    body = data[end + len(b"end_header") + 1:]
    fmt = "ascii"
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))
    type_map = {"float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
                "uchar": ("u1", 1), "uint8": ("u1", 1), "int": ("i4", 4),
                "uint": ("u4", 4), "short": ("i2", 2), "ushort": ("u2", 2)}
    if fmt == "ascii":
        rows = body.decode().strip().split("\n")
        verts = np.array(
            [[float(x) for x in r.split()[:3]] for r in rows[:n_vert]],
            np.float32,
        )
        faces = None
        if n_face:
            faces = np.array(
                [[int(x) for x in r.split()[1:4]]
                 for r in rows[n_vert:n_vert + n_face]],
                np.int32,
            )
        return verts, faces
    dtype = np.dtype([(name, type_map[t][0]) for name, t in vert_props])
    verts_rec = np.frombuffer(body, dtype=dtype, count=n_vert)
    verts = np.stack(
        [verts_rec["x"], verts_rec["y"], verts_rec["z"]], -1
    ).astype(np.float32)
    faces = None
    if n_face:
        off = n_vert * dtype.itemsize
        face_dtype = np.dtype([("n", "u1"), ("idx", "i4", 3)])
        faces = np.frombuffer(
            body, dtype=face_dtype, count=n_face, offset=off
        )["idx"].astype(np.int32)
    return verts, faces


def sample_mesh_points(vertices: np.ndarray, faces: Optional[np.ndarray],
                       n_points: int, seed: int = 0) -> np.ndarray:
    """Uniform surface sampling (replaces o3d sample_points_uniformly)."""
    rng = np.random.default_rng(seed)
    if faces is None or len(faces) == 0:
        if len(vertices) == 0:
            return np.zeros((0, 3), np.float32)
        idx = rng.integers(0, len(vertices), n_points)
        return vertices[idx]
    tri = vertices[faces]  # [M, 3, 3]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    p = areas / max(areas.sum(), 1e-12)
    choice = rng.choice(len(faces), n_points, p=p)
    r1 = np.sqrt(rng.uniform(size=(n_points, 1)))
    r2 = rng.uniform(size=(n_points, 1))
    t = tri[choice]
    return ((1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1] + r1 * r2 * t[:, 2]
            ).astype(np.float32)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one point per voxel (replaces o3d voxel_down_sample)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]
