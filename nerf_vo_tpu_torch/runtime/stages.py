"""Pipeline stages: tracking -> enhancement -> mapping.

Counterpart of the ``TrackingStage``, ``EnhancementStage`` and
``MappingStage`` of ``nerf_vo_tpu/runtime/stages.py``: the same ``args``
keys and entry points (``step(frame) -> packet``, ``step(packet) ->
enhanced``, ``update(enhanced)`` / ``train_step()`` / ``finish()``). A
frame is the dict the data stage yields (``frame_index``, ``frame_color``
[H, W, 3] uint8, ``camera_intrinsics`` {fx, fy, cx, cy}, optional
``last_frame``); the enhanced packet is what the mapping stage consumes.
The stages run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_vo_tpu_torch.core import conventions
from nerf_vo_tpu_torch.enhancement import alignment
from nerf_vo_tpu_torch.enhancement.omnidata import OmnidataEstimator
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models.dpvo_net import DPVONet
from nerf_vo_tpu_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from nerf_vo_tpu_torch.tracking.dpvo import DPVOTracker, TrackingConfig
from nerf_vo_tpu_torch.utils.torch_setup import set_float_policy


class TrackingStage:
    """Tracking (reference TrackingModule), the ``dpvo`` module."""

    def __init__(self, args, state_dict: Optional[Dict] = None,
                 device="cuda"):
        """``state_dict``: DPVO weights in upstream's layout (see
        ``models.dpvo_net.from_jax_params``); random weights from seed 42
        otherwise."""
        set_float_policy()
        name =getattr(args, "tracking_module", "dpvo")
        if name != "dpvo":
            raise NotImplementedError(
                f"tracking_module {name!r}: only 'dpvo' is ported")
        cfg = TrackingConfig(
            patches_per_frame=getattr(args, "patches_per_frame", 96),
            removal_window=getattr(args, "removal_window", 28),
            optimization_window=getattr(args, "optimization_window", 13),
            patch_lifetime=getattr(args, "patch_lifetime", 15),
            keyframe_threshold=getattr(args, "keyframe_threshold", 8.0),
            init_frames=getattr(args, "tracking_init_frames", 8),
            max_edges=getattr(args, "tracking_max_edges", 32768),
            ring_size=getattr(args, "tracking_ring_size", 32),
            max_frames=getattr(args, "tracking_max_frames", 4096),
        )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(42)
            net = DPVONet(corr_radius=cfg.corr_radius)
        if state_dict is not None:
            net.load_state_dict(state_dict)
        self.tracker = DPVOTracker(cfg, net, args.frame_height,
                                   args.frame_width, device=device)

    def step(self, frame: Optional[dict]) -> Optional[dict]:
        if frame is None:
            gids = self.tracker.flush()
            return self.tracker.keyframe_packet(gids, last_frame=True)
        ci = frame["camera_intrinsics"]
        intr = np.asarray([ci["fx"], ci["fy"], ci["cx"], ci["cy"]],
                          np.float32)
        retired = self.tracker.track(
            float(frame["frame_index"]), frame["frame_color"], intr,
            frame_index=frame["frame_index"],
        )
        if frame.get("last_frame"):
            retired = retired + self.tracker.flush()
            return self.tracker.keyframe_packet(retired, last_frame=True)
        return self.tracker.keyframe_packet(retired)


class EnhancementStage:
    """Dense priors + alignment (reference EnhancementModule)."""

    def __init__(self, args, depth_state_dict: Optional[Dict] = None,
                 normal_state_dict: Optional[Dict] = None, device="cuda"):
        """State dicts in the Omnidata layout (see
        ``models.dpt.from_jax_params``); random weights otherwise."""
        set_float_policy()
        self.mode = getattr(args, "enhancement_module", "depth")
        self.device = torch.device(device)
        self.estimator = (
            OmnidataEstimator(
                depth_state_dict, normal_state_dict,
                use_normals="normal" in self.mode,
                image_size=getattr(args, "enhancement_image_size", 384),
                depth_layers=getattr(args, "enhancement_dpt_layers", 12),
                device=self.device,
            )
            if self.mode != "none" else None
        )

    @torch.no_grad()
    def step(self, packet: Optional[dict]) -> Optional[dict]:
        if packet is None:
            return None
        out = dict(packet)
        # colors: [K, 3, H, W] uint8 -> [K, H, W, 3] f32 in [0, 1]
        colors_u8 = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(packet["frames_color"], 1, -1))).to(self.device)
        colors = colors_u8.float() / 255.0
        out["frames_color_float"] = colors
        if self.estimator is not None and "dpvo_patches" in packet:
            depth_raw, normal_raw = self.estimator(colors)
            patches = packet["dpvo_patches"].to(self.device)  # [K,P,3,3,3]
            centers = patches[:, :, :2, 1, 1]  # (x, y) at 1/4 res
            invd = patches[:, :, 2, 1, 1]
            out["frames_depth"], _, _ = alignment.align_frames(
                depth_raw, centers, invd)
            if normal_raw is not None:
                out["frames_normal"] = alignment.decode_normals(normal_raw)
        # OpenCV -> OpenGL camera axes: the mapper is OpenGL-native
        out["camera_extrinsics"] = conventions.opencv_to_opengl(
            packet["camera_extrinsics"].to(self.device))
        return out


def mapping_model_config(args) -> NerfactoConfig:
    """The mapper's ``NerfactoConfig`` for a run's ``args``: the nerfstudio
    mapper's settings, then ``mapping_model_overrides`` applied field for
    field (lists become tuples)."""
    use_normals = "normal" in getattr(args, "enhancement_module", "depth")
    cfg = NerfactoConfig(
        near=0.05,
        far=20.0,
        num_images=args.num_keyframes,
        predict_normals=True,
        depth_loss_type="ds_nerf",
        depth_loss_mult=getattr(args, "depth_supervision_lambda", 0.001),
        normal_loss_mult=5e-6 if use_normals else 0.0,
        use_contraction=True,
        aabb_min=-4.0,
        aabb_max=4.0,
        sampler="proposal",
        spacing="disparity",
    )
    overrides = getattr(args, "mapping_model_overrides", None)
    if overrides:
        fields = {f.name for f in dataclasses.fields(NerfactoConfig)}
        clean = {}
        for k, v in dict(overrides).items():
            if k not in fields:
                raise ValueError(f"unknown NerfactoConfig field in "
                                 f"mapping_model_overrides: {k!r}")
            clean[k] = tuple(v) if isinstance(v, list) else v
        cfg = dataclasses.replace(cfg, **clean)
    return cfg


class MappingStage:
    """Online NeRF mapping (reference MappingModule), the ``nerfstudio``
    module: a keyframe buffer fed by enhanced packets and a nerfacto
    trainer paced against the keyframe stream."""

    def __init__(self, args, state_dict: Optional[Dict] = None,
                 device="cuda"):
        """``state_dict``: :class:`NerfactoModel` parameters (see
        ``models.nerfacto.from_jax_params``); random from seed 42
        otherwise. Train-step draws come from a generator seeded 7."""
        set_float_policy()
        name = getattr(args, "mapping_module", "nerfstudio")
        if name != "nerfstudio":
            raise NotImplementedError(
                f"mapping_module {name!r}: only 'nerfstudio' is ported")
        K = args.num_keyframes
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(42)
            self.model = NerfactoModel(mapping_model_config(args))
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.mapping_iterations = args.mapping_iterations
        self.trainer = MappingTrainer(
            self.model,
            TrainerConfig(
                rays_per_batch=getattr(args, "rays_per_batch", 4096),
                camera_learning_rate=getattr(args, "extrinsic_learning_rate",
                                             1e-4),
                max_iterations=args.mapping_iterations,
            ),
            num_keyframes=K, device=self.device,
        )
        self.state = self.trainer.init()
        use_normals = "normal" in getattr(args, "enhancement_module", "depth")
        self.buffer = kb.create(K, args.frame_height, args.frame_width,
                                use_normals=use_normals, device=self.device)
        self.num_keyframes = K
        self.num_inserted = 0
        self.step_count = 0
        self.last_received = 0
        self.stream_active = True
        self.metrics_history: List[Dict[str, float]] = []

    # -- keyframe stream ------------------------------------------------

    def update(self, packet: dict) -> None:
        n = packet["camera_extrinsics"].shape[0]
        take = min(n, self.num_keyframes - self.num_inserted)
        if take <= 0:
            return

        def rows(key):  # buffer full: keep the first `take`
            return torch.as_tensor(packet[key])[:take]

        ins = {"intrinsics": rows("camera_intrinsics"),
               "c2w": rows("camera_extrinsics"),
               "color": rows("frames_color_float")}
        for src, dst in (("frames_depth", "depth"),
                         ("frames_normal", "normal"),
                         ("frames_depth_cov", "depth_cov")):
            if src in packet:
                ins[dst] = rows(src)
        idx = torch.arange(self.num_inserted, self.num_inserted + take)
        kb.insert(self.buffer, idx, ins)
        self.num_inserted += take
        self.last_received = 0

    # -- training -------------------------------------------------------

    def can_train(self) -> bool:
        if self.step_count >= self.mapping_iterations:
            return False
        if self.num_inserted == 0:
            return False
        if not self.stream_active:
            return True
        # pacing rule (reference mapping_module.py:36-47): at most
        # mapping_iterations/num_keyframes consecutive train steps between
        # keyframe packets (the counter resets on every insert)
        budget = self.mapping_iterations / max(self.num_keyframes, 1)
        return self.last_received < budget

    def train_step(self, draws: Optional[Dict] = None
                   ) -> Optional[Dict[str, torch.Tensor]]:
        """One paced train step (None when the pacing rule says wait).
        ``draws``: the step's random draws (see ``MappingTrainer``)."""
        if not self.can_train():
            return None
        self.state, metrics = self.trainer.train_step(self.state, self.buffer,
                                                      draws)
        self.step_count += 1
        self.last_received += 1
        return metrics

    def finish(self) -> None:
        """Train to completion after the stream ends
        (reference mapping_module.py:49-52)."""
        self.stream_active = False
        while self.step_count < self.mapping_iterations and self.num_inserted:
            m = self.train_step()
            if m is not None and self.step_count % 512 == 0:
                self.metrics_history.append(
                    {k: float(v) for k, v in m.items()})
