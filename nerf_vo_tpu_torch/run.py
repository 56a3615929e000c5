"""The PyTorch port's command line: run the NeRF-VO pipeline over a
config's scenes.

    python -m nerf_vo_tpu_torch.run --config nerf_vo_replica \
        --experiment my_run --first_scene 0 --last_scene 7

The same flags, ``configs/<name>.yaml`` files (read from the working
directory), per-scene overrides and prediction-directory tree as the JAX
package's ``run.py`` (reference run.py:96-174):
``<dir_prediction>/<config>_<stamp>_<experiment>/{config.json, <scene>/,
results/<scene>/}``. Each scene runs :func:`runtime.pipeline.execute` on
the card. Evaluation (rendering and metrics) is not ported yet: for each
scene the CLI prints a line that says so and names the scene's
prediction directory.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
from typing import List, Optional

import numpy as np
import torch

from nerf_vo_tpu_torch.runtime.pipeline import execute


def _set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv: Optional[List[str]] = None, device="cuda") -> None:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run every selected
    scene on ``device``."""
    parser = argparse.ArgumentParser(
        description="Execute NeRF-VO (PyTorch port) over a config's scenes."
    )
    parser.add_argument("--config", type=str, default="nerf_vo_replica",
                        help="name of the config")
    parser.add_argument("--experiment", type=str, default="1st_commit",
                        help="experiment name to identify execution")
    parser.add_argument("--first_scene", type=int, default=0,
                        help="first scene to process")
    parser.add_argument("--last_scene", type=int, default=7,
                        help="last scene to process")
    cli = parser.parse_args(argv)

    import yaml

    with open(f"configs/{cli.config}.yaml", "r") as f:
        config = yaml.safe_load(f)

    dir_dataset = config["dir_dataset"]
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    suffix = "" if cli.experiment == "" else f"_{cli.experiment}"
    dir_prediction = config["dir_prediction"] + f"/{cli.config}_{stamp}{suffix}"
    experiment = (
        f"/{cli.config}_{stamp}" if cli.experiment == "" else cli.experiment
    )
    os.makedirs(dir_prediction, exist_ok=True)
    dir_result = dir_prediction + "/results"
    os.makedirs(dir_result, exist_ok=True)

    with open(dir_prediction + "/config.json", "w") as f:
        json.dump(config, f)

    _set_random_seed(42)

    for index, scene_name in enumerate(config["scene_names"]):
        if index < cli.first_scene:
            continue
        if index > cli.last_scene:
            break

        config["dir_dataset"] = dir_dataset + f"/{scene_name}"
        config["dir_prediction"] = dir_prediction + f"/{scene_name}"
        os.makedirs(config["dir_prediction"], exist_ok=True)
        config["dir_result"] = dir_result + f"/{scene_name}"
        os.makedirs(config["dir_result"], exist_ok=True)
        config["experiment"] = experiment
        config["scene_name"] = scene_name
        # per-scene overrides (reference run.py:156-161)
        if "depth_supervision_lambdas" in config:
            config["depth_supervision_lambda"] = config[
                "depth_supervision_lambdas"
            ][index]
        if "extrinsic_learning_rates" in config:
            config["extrinsic_learning_rate"] = config[
                "extrinsic_learning_rates"
            ][index]
        args = argparse.Namespace(**config)
        execute(args, device=device)
        print(f"[{scene_name}] evaluation is not ported to "
              f"nerf_vo_tpu_torch yet; predictions in "
              f"{config['dir_prediction']}", flush=True)


if __name__ == "__main__":
    main()
