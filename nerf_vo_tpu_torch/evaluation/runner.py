"""Glue: execute -> render -> evaluate for one scene (reference
run.py:29-91's ``execute_render_and_evaluate`` back half). The port's
counterpart of ``nerf_vo_tpu/evaluation/runner.py``: everything runs on the
mapping stage's device."""

from __future__ import annotations

import argparse
from typing import Dict

from nerf_vo_tpu_torch.evaluation.datasets import make_dataset
from nerf_vo_tpu_torch.evaluation.evaluator import Evaluator
from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer
from nerf_vo_tpu_torch.evaluation.renderer import Renderer


def render_and_evaluate(args: argparse.Namespace, config: dict,
                        mapping_stage) -> Dict[str, Dict]:
    nerf = MapRenderer(mapping_stage)
    dataset = make_dataset(config, nerf.device)

    renderer = Renderer(config=config, dataset=dataset, nerf=nerf)
    renderer.render_camera_extrinsics_keyframes()
    renderer.render_frames()
    renderer.render_mesh(source="frames")
    if config.get("render_poisson_mesh", False):
        # opt-in Poisson surface reconstruction (reference
        # nerf_renderer.py:170-209 offers Poisson export alongside TSDF)
        renderer.render_mesh(source="poisson")

    evaluator = Evaluator(config=config, dataset=dataset,
                          device=nerf.device)
    metrics = {
        "trajectory": evaluator.calculate_metrics_trajectory(),
        "2d": evaluator.calculate_metrics_2d(),
        "3d": evaluator.calculate_metrics_3d(),
    }
    print(metrics["trajectory"])
    print(metrics["2d"])
    print(metrics["3d"])
    return metrics
