"""The configurations' files hold the YAML configurations as run: every
key of ``configs/<name>.yaml`` with its value, apart from the keys that
name the dataset on disk and the output directory (``chip_smoke.py``'s
``SOURCE_KEYS``), and every key changed is listed in ``reduced``. The
mapper runs nerfacto's published widths, which the YAML's ``nerfstudio``
module names and ``mapping_model_overrides`` sets."""

import json

import pytest
import yaml

from benchmark import harness
from benchmark.reference import mapper

ROOT = harness.ROOT
SOURCE_KEYS = ("dir_dataset", "dataset_name", "scene_names", "cache_dataset",
               "first_frame_index", "last_frame_index", "dir_prediction",
               "num_evaluation_frames")


@pytest.mark.parametrize("name", ["nerf_vo_replica"])
def test_config_is_the_yaml(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    src = yaml.safe_load((ROOT / f"configs/{name}.yaml").read_text())
    for k, v in src.items():
        if k not in SOURCE_KEYS:
            assert cfg[k] == v, k
    changed = [k for k in cfg if k not in src
               and k not in ("source", "reduced", "assumed",
                             "mapping_model_overrides")]
    assert sorted(changed) == sorted(cfg["reduced"])
    assert cfg["source"] and len(cfg["source"]) <= 200


def test_mapper_is_nerfactos_published():
    cfg = json.loads((ROOT / "benchmark/configs/nerf_vo_replica.json")
                     .read_text())
    assert cfg["mapping_module"] == "nerfstudio"
    assert cfg["mapping_model_overrides"] == mapper.PUBLISHED
    mc = mapper.model_config(cfg)
    assert (mc.num_grid_levels, mc.grid_features_per_level) == (16, 2)
    assert [(g.n_levels, g.features, g.max_res) for g in mc.proposal_grids] \
        == [(5, 2, 128), (5, 2, 256)]
