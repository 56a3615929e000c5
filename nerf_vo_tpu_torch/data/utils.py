"""Dataset utility functions: camera-parameter loading, timestamp association.

The port's own copy of ``nerf_vo_tpu/data/utils.py`` (stdlib only), itself a
behavior-parity rewrite of nerf_vo/data/data_utils.py:5-74 (reference):
same ``camera_parameters.json`` schema, same intrinsic scaling, same TUM-style
timestamp file parsing and greedy nearest-timestamp association with a 0.02 s
window.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

MAX_TIMESTAMP_DIFFERENCE = 0.02


def load_camera_intrinsics(dir_dataset: str, dataset_name: str) -> dict:
    """Read `<parent>/camera_parameters.json` (reference data_utils.py:5-21)."""
    path = os.path.join(os.path.dirname(dir_dataset), "camera_parameters.json")
    with open(path, "r") as f:
        params = json.load(f)[dataset_name]
    out = {
        "height": params["h"],
        "width": params["w"],
        "fx": params["fx"],
        "fy": params["fy"],
        "cx": params["cx"],
        "cy": params["cy"],
        "depth_scale": params["depth_scale"],
    }
    for key in ("k1", "k2", "k3", "p1", "p2"):
        if key in params:
            out[key] = params[key]
    return out


def scale_camera_intrinsics(camera_intrinsics: dict, height: int, width: int) -> dict:
    """Scale intrinsics to a target resolution (reference data_utils.py:24-34)."""
    out = dict(camera_intrinsics)
    sx = width / out["width"]
    sy = height / out["height"]
    out["height"] = height
    out["width"] = width
    out["fx"] *= sx
    out["fy"] *= sy
    out["cx"] *= sx
    out["cy"] *= sy
    return out


def read_timestamp_data(dir_dataset: str, mode: str = "color") -> Dict[float, list]:
    """Parse TUM-style association files (reference data_utils.py:37-54)."""
    names = {
        "color": "rgb.txt",
        "depth": "depth.txt",
        "camera_extrinsics": "groundtruth.txt",
    }
    if mode not in names:
        raise NotImplementedError(mode)
    with open(os.path.join(dir_dataset, names[mode])) as f:
        data = f.read()
    lines = data.replace(",", " ").replace("\t", " ").split("\n")
    rows = [
        [el.strip() for el in line.split(" ") if el.strip() != ""]
        for line in lines
        if len(line) > 0 and line[0] != "#"
    ]
    return {float(r[0]): r[1:] for r in rows if len(r) > 1}


def associate_timestamp_data(
    source_timestamps: List[float], target_timestamps: List[float]
) -> List[Tuple[float, float]]:
    """Greedy best-first timestamp matching, max diff 0.02 s
    (reference data_utils.py:57-74). Consumes the input lists like the
    reference does."""
    potential = sorted(
        (abs(s - t), s, t)
        for s in source_timestamps
        for t in target_timestamps
        if abs(s - t) < MAX_TIMESTAMP_DIFFERENCE
    )
    matches = []
    src = set(source_timestamps)
    tgt = set(target_timestamps)
    for _, s, t in potential:
        if s in src and t in tgt:
            src.remove(s)
            tgt.remove(t)
            matches.append((s, t))
    # mirror reference list mutation semantics
    source_timestamps[:] = [s for s in source_timestamps if s in src]
    target_timestamps[:] = [t for t in target_timestamps if t in tgt]
    return matches


def even_padding(size: int, fraction: float = 0.1) -> int:
    """Reference pad-resize-crop trick: 10% padding rounded up to even
    (scannet_dataset.py:37-40, tum_rgbd_dataset.py:57-60)."""
    pad = int(size * fraction)
    return pad if pad % 2 == 0 else pad + 1
