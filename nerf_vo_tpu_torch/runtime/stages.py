"""Pipeline stages: data -> tracking -> enhancement -> mapping.

Counterpart of ``nerf_vo_tpu/runtime/stages.py``: the same ``args`` keys
and entry points (``DataStage.step() -> frame``, ``step(frame) -> packet``,
``step(packet) -> enhanced``, ``update(enhanced)`` / ``train_step()`` /
``finish()``) and the same prediction-directory artifacts
(``TrackingStage.save_artifacts``, ``MappingStage.save_snapshot``). A frame
is the dict the data stage yields (``frame_index``, ``frame_color``
[H, W, 3] uint8, ``camera_intrinsics`` {fx, fy, cx, cy}, optional
``last_frame``); the enhanced packet is what the mapping stage consumes.
The data stage stays on the host; the other stages run on ``cuda`` unless
the caller passes ``device="cpu"``, and ``_pick_device`` moves the
enhancement or mapping stage to the card that an ``<stage>_device: N``
config key names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_vo_tpu_torch.core import conventions
from nerf_vo_tpu_torch.data.datasets import make_dataset
from nerf_vo_tpu_torch.enhancement import alignment
from nerf_vo_tpu_torch.enhancement.omnidata import OmnidataEstimator
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models import droid_net, dpvo_net
from nerf_vo_tpu_torch.models.dpvo_net import DPVONet
from nerf_vo_tpu_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from nerf_vo_tpu_torch.runtime.viewer import LiveViewer
from nerf_vo_tpu_torch.tracking.dpvo import DPVOTracker, TrackingConfig
from nerf_vo_tpu_torch.tracking.droid_slam import DroidConfig, DROIDSLAMTracker
from nerf_vo_tpu_torch.utils.torch_setup import set_float_policy


class DataStage:
    """Frame source (reference DataModule). ``dataset``: any object with
    ``__len__`` and ``__getitem__`` that returns the frame dict; the
    dataset that ``args.dataset_name`` names otherwise. Host only: the
    tracker uploads each frame itself."""

    def __init__(self, args, dataset=None):
        self.dataset = (dataset if dataset is not None
                        else make_dataset(args.dataset_name, args))
        self.index = 0

    def step(self) -> Optional[dict]:
        if self.index >= len(self.dataset):
            return None
        frame = self.dataset[self.index]
        self.index += 1
        return frame

    def __len__(self):
        return len(self.dataset)


class TrackingStage:
    """Tracking (reference TrackingModule): ``dpvo`` or ``droid-slam``."""

    def __init__(self, args, state_dict: Optional[Dict] = None,
                 device="cuda"):
        """``state_dict``: the tracker's weights in upstream's layout (see
        ``from_jax_params`` in ``models.dpvo_net`` / ``models.droid_net``);
        otherwise the checkpoint that ``NERF_VO_DPVO_WEIGHTS`` (a
        ``dpvo.pth``) or, for ``droid-slam``, ``NERF_VO_DROID_WEIGHTS`` (a
        ``droid.pth``) names, which must load; random weights from seed 42
        when neither is given."""
        set_float_policy()
        self.name = getattr(args, "tracking_module", "dpvo")
        self.frame_stride = getattr(args, "frame_stride", 1)
        if self.name == "droid-slam":
            self._init_droid(args, state_dict, device)
            return
        if self.name != "dpvo":
            raise NotImplementedError(
                f"tracking_module {self.name!r}: only 'dpvo' and "
                "'droid-slam' are ported")
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
        if state_dict is None and os.environ.get("NERF_VO_DPVO_WEIGHTS"):
            state_dict = dpvo_net.load_torch_weights(
                os.environ["NERF_VO_DPVO_WEIGHTS"])
        if state_dict is not None:
            net.load_state_dict(state_dict)
        self.tracker = DPVOTracker(cfg, net, args.frame_height,
                                   args.frame_width, device=device)

    def _init_droid(self, args, state_dict, device) -> None:
        """The DROID tracker on the frame cropped to a multiple of 8."""
        H = args.frame_height - args.frame_height % 8
        W = args.frame_width - args.frame_width % 8
        cfg = DroidConfig(
            buffer_size=getattr(args, "num_keyframes", 512),
            motion_threshold=getattr(args, "motion_threshold", 2.4),
            keyframe_threshold=getattr(args, "keyframe_threshold", 4.0),
            frontend_window=getattr(args, "tracking_frontend_window", 25),
            max_factors=getattr(args, "tracking_max_edges", 48),
            perform_global_ba=getattr(
                args, "perform_global_bundle_adjustment", True),
            compute_covariances=getattr(args, "compute_covariances", True),
        )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(42)
            net = droid_net.DroidNet()
        if state_dict is None and os.environ.get("NERF_VO_DROID_WEIGHTS"):
            state_dict = droid_net.load_torch_weights(
                os.environ["NERF_VO_DROID_WEIGHTS"])
        if state_dict is not None:
            net.load_state_dict(state_dict)
        self.tracker = DROIDSLAMTracker(cfg, net, H, W, device=device)

    def step(self, frame: Optional[dict]) -> Optional[dict]:
        if frame is None:
            gids = self.tracker.flush()
            return self.tracker.keyframe_packet(gids, last_frame=True)
        ci = frame["camera_intrinsics"]
        intr = np.asarray([ci["fx"], ci["fy"], ci["cx"], ci["cy"]],
                          np.float32)
        color = frame["frame_color"]
        if self.name == "droid-slam":  # crop to a multiple of 8
            color = color[:self.tracker.H, :self.tracker.W]
        retired = self.tracker.track(
            float(frame["frame_index"]), color, intr,
            frame_index=frame["frame_index"],
        )
        if frame.get("last_frame"):
            retired = retired + self.tracker.flush()
            return self.tracker.keyframe_packet(retired, last_frame=True)
        return self.tracker.keyframe_packet(retired)

    def save_artifacts(self, dir_prediction: str) -> None:
        """mapping_keyframe2frame.json + tracking trajectory matrices
        (reference nerf_vo/tracking/dpvo.py:118-138). Frame indices count
        the dataset's files: a dataset index times ``frame_stride``."""
        os.makedirs(os.path.join(dir_prediction, "matrices"), exist_ok=True)
        tr = self.tracker
        kf2frame = {str(i): int(tr.src_index[g]) * self.frame_stride
                    for i, g in enumerate(tr.retired)}
        with open(os.path.join(dir_prediction, "mapping_keyframe2frame.json"),
                  "w") as f:
            json.dump(kf2frame, f)
        traj = tr.trajectory()
        mats = {str(int(tr.src_index[g]) * self.frame_stride): traj[g].tolist()
                for g in tr.retired}
        with open(os.path.join(
                dir_prediction, "matrices",
                "matrices_origin2frame_keyframes_tracking.json"), "w") as f:
            json.dump(mats, f)


def _pick_device(args, name: str, default) -> torch.device:
    """The device of stage ``name``: ``cuda:N`` where the config sets
    ``<name>_device: N`` (``mapping_device: 1`` puts the NeRF train step
    on a card of its own), else ``default``."""
    idx = getattr(args, f"{name}_device", None)
    if idx is None:
        return torch.device(default)
    n = torch.cuda.device_count()
    if idx >= n:
        raise ValueError(f"{name}_device={idx} but only {n} devices present")
    return torch.device("cuda", idx)


class EnhancementStage:
    """Dense priors + alignment (reference EnhancementModule)."""

    def __init__(self, args, depth_state_dict: Optional[Dict] = None,
                 normal_state_dict: Optional[Dict] = None, device="cuda"):
        """State dicts in the Omnidata layout (see
        ``models.dpt.from_jax_params``); otherwise the checkpoints that
        ``NERF_VO_OMNIDATA_DEPTH_WEIGHTS`` and, with normals,
        ``NERF_VO_OMNIDATA_NORMAL_WEIGHTS`` name (``OmnidataEstimator``);
        random weights otherwise."""
        set_float_policy()
        self.mode = getattr(args, "enhancement_module", "depth")
        self.device = _pick_device(args, "enhancement", device)
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
        elif "droid_slam_inverse_depth" in packet:
            # DROID: depth = 1 / inverse depth (reference
            # enhancement_module.py:106-111), the covariance passed on
            inv = packet["droid_slam_inverse_depth"].to(self.device)
            out["frames_depth"] = (1.0 / inv.clamp(min=1e-6)).clamp(
                0.0, alignment.MAX_DEPTH)
            if "droid_slam_depth_covariance" in packet:
                out["frames_depth_cov"] = packet[
                    "droid_slam_depth_covariance"].to(self.device)
        # OpenCV -> OpenGL camera axes: the mapper is OpenGL-native
        out["camera_extrinsics"] = conventions.opencv_to_opengl(
            packet["camera_extrinsics"].to(self.device))
        return out


MAPPING_MODULES = ("nerfstudio", "instant-ngp", "neuralangelo")


def mapping_model_config(args) -> NerfactoConfig:
    """The mapper's ``NerfactoConfig`` for a run's ``args``: the nerfstudio
    mapper's settings, under ``mapping_module: instant-ngp`` the NGP
    mapper's (covariance-weighted L2 depth, no contraction, the occupancy
    sampler with linear spacing in the bounded AABB), or under
    ``neuralangelo`` Neuralangelo's SDF mapper (``sampler="sdf"``: a 16 x 8
    hash grid at log2 22 from 32 to 2048 over the sphere of radius 4.5
    about the first keyframe, no depth or normal terms); then
    ``mapping_model_overrides`` applied field for field (lists become
    tuples; an ``sdf`` dict sets those fields of ``SDFConfig``: its sample
    counts and schedules)."""
    use_normals = "normal" in getattr(args, "enhancement_module", "depth")
    module = getattr(args, "mapping_module", "nerfstudio")
    ngp = module == "instant-ngp"
    cfg = NerfactoConfig(
        near=0.05,
        far=20.0,
        num_images=args.num_keyframes,
        predict_normals=True,
        depth_loss_type="l2" if ngp else "ds_nerf",
        depth_loss_mult=getattr(args, "depth_supervision_lambda", 0.001),
        normal_loss_mult=5e-6 if use_normals else 0.0,
        use_contraction=not ngp,
        aabb_min=-4.0,
        aabb_max=4.0,
        sampler="occupancy" if ngp else "proposal",
        spacing="linear" if ngp else "disparity",
    )
    if module == "neuralangelo":
        cfg = dataclasses.replace(
            cfg, sampler="sdf", use_contraction=False, aabb_min=-4.5,
            aabb_max=4.5, predict_normals=False, depth_loss_mult=0.0,
            normal_loss_mult=0.0, num_grid_levels=16,
            grid_features_per_level=8, log2_hashmap_size=22, max_res=2048)
    overrides = getattr(args, "mapping_model_overrides", None)
    if overrides:
        fields = {f.name for f in dataclasses.fields(NerfactoConfig)}
        clean = {}
        for k, v in dict(overrides).items():
            if k not in fields:
                raise ValueError(f"unknown NerfactoConfig field in "
                                 f"mapping_model_overrides: {k!r}")
            clean[k] = tuple(v) if isinstance(v, list) else v
        if isinstance(clean.get("sdf"), dict):
            clean["sdf"] = dataclasses.replace(cfg.sdf, **clean["sdf"])
        cfg = dataclasses.replace(cfg, **clean)
    return cfg


def _require_cv2(option: str) -> None:
    """Fail when the stage is built, not at the first preview, where an
    option that writes images runs without OpenCV."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{option} encodes images with OpenCV, and cv2 "
                          "is not installed") from e


def _image_u8(out: Dict[str, torch.Tensor]):
    """A render's rgb as [H, W, 3] uint8 and its depth scaled to its
    maximum as [H, W] uint8."""
    rgb = (out["rgb"] * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
    depth = out["depth"].cpu().numpy()
    dnorm = np.clip(depth / max(float(depth.max()), 1e-6) * 255, 0,
                    255).astype(np.uint8)
    return rgb, dnorm


class MappingStage:
    """Online NeRF mapping (reference MappingModule), the ``nerfstudio``,
    ``instant-ngp`` or ``neuralangelo`` module: a keyframe buffer fed by
    enhanced packets (with a depth-covariance channel under
    ``instant-ngp``) and a trainer paced against the keyframe stream.
    Optional: preview renders in ``<dir_prediction>/previews`` every
    ``preview_iterations`` steps, and the live web viewer (``viewer:
    true``)."""

    def __init__(self, args, state_dict: Optional[Dict] = None,
                 device="cuda"):
        """``state_dict``: :class:`NerfactoModel` parameters (see
        ``models.nerfacto.from_jax_params``); random from seed 42
        otherwise. Train-step draws come from a generator seeded 7. The
        stage runs on ``cuda:N`` where ``args`` sets ``mapping_device: N``,
        else on ``device``."""
        set_float_policy()
        name = getattr(args, "mapping_module", "nerfstudio")
        if name not in MAPPING_MODULES:
            raise NotImplementedError(
                f"mapping_module {name!r}: only 'nerfstudio', "
                "'instant-ngp' and 'neuralangelo' are ported")
        self.device = _pick_device(args, "mapping", device)
        # preview renders and the viewer replace the reference's viser
        # viewer (nerf_vo/mapping/nerfstudio.py:101-102,125-137)
        self.preview_every = getattr(args, "preview_iterations", 0)
        self.preview_dir = (
            os.path.join(getattr(args, "dir_prediction", "."), "previews")
            if self.preview_every else None)
        if self.preview_every:
            _require_cv2("preview_iterations")
        want_viewer = getattr(args, "viewer", False)
        if want_viewer:
            _require_cv2("viewer: true")
        K = args.num_keyframes
        self.args = args
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(42)
            self.model = NerfactoModel(mapping_model_config(args))
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.mapping_iterations = args.mapping_iterations
        self.snapshot_every = getattr(args, "mapping_snapshot_iterations",
                                      args.mapping_iterations)
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
                                use_normals=use_normals,
                                use_depth_cov=name == "instant-ngp",
                                device=self.device)
        self.num_keyframes = K
        self.num_inserted = 0
        self.step_count = 0
        self.last_received = 0
        self.stream_active = True
        self.metrics_history: List[Dict[str, float]] = []
        # the viewer only mailboxes cameras and JPEGs: renders stay on the
        # thread that trains
        self.viewer = None
        self.viewer_every = getattr(args, "viewer_render_every", 25)
        self.viewer_width = getattr(args, "viewer_width", 160)
        if want_viewer:
            self.viewer = LiveViewer(port=getattr(args, "viewer_port", 7007))
            self.viewer.start()

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
        if self.preview_every and self.step_count % self.preview_every == 0:
            self._dump_preview()
        if (self.viewer is not None
                and self.step_count % self.viewer_every == 0):
            self._push_viewer(metrics)
        return metrics

    @torch.no_grad()
    def _push_viewer(self, metrics) -> None:
        """Render the viewer's camera (the newest keyframe's in follow
        mode) at ``viewer_width`` and publish it with the step's loss."""
        import cv2

        H, W = self.buffer.hw
        vw = min(self.viewer_width, W)
        scale = vw / W
        vh = max(int(round(H * scale)), 1)
        intr = self.buffer.intrinsics[0] * scale
        poses = self.trainer.optimized_c2w(self.state, self.buffer)[
            :self.num_inserted].cpu().numpy()
        cam = self.viewer.requested_camera()
        c2w = cam if cam is not None else poses[self.num_inserted - 1]
        rgb, dnorm = _image_u8(
            self.trainer.render_image(self.state, c2w, intr, vh, vw))
        _, rgb_jpg = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        _, d_jpg = cv2.imencode(".jpg", dnorm)
        stats = {"step": float(self.step_count)}
        for k in ("loss", "psnr"):
            if k in metrics:
                stats[k] = float(metrics[k])
        self.viewer.publish(rgb_jpg.tobytes(), d_jpg.tobytes(), stats, poses)

    @torch.no_grad()
    def _dump_preview(self) -> None:
        """Keyframe 0 rendered at full size: ``rgb_<step>.jpg`` and
        ``depth_<step>.png`` in the preview directory."""
        import cv2

        os.makedirs(self.preview_dir, exist_ok=True)
        H, W = self.buffer.hw
        rgb, dnorm = _image_u8(self.trainer.render_image(
            self.state,
            self.trainer.optimized_c2w(self.state, self.buffer)[0],
            self.buffer.intrinsics[0], H, W))
        cv2.imwrite(
            os.path.join(self.preview_dir, f"rgb_{self.step_count:06d}.jpg"),
            cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(
            os.path.join(self.preview_dir,
                         f"depth_{self.step_count:06d}.png"), dnorm)

    def finish(self) -> None:
        """Train to completion after the stream ends
        (reference mapping_module.py:49-52)."""
        self.stream_active = False
        while self.step_count < self.mapping_iterations and self.num_inserted:
            m = self.train_step()
            if m is not None and self.step_count % 512 == 0:
                self.metrics_history.append(
                    {k: float(v) for k, v in m.items()})

    # -- artifacts ------------------------------------------------------

    def _train_state(self) -> Dict:
        """The full resumable state. ``model.state_dict()`` and not
        ``state.params``: the distilled proposal grids take no gradient,
        so they are not in ``state.params``, but a render needs them, as
        it needs the occupancy grid under ``instant-ngp``."""
        st = self.state
        full = {"model": self.model.state_dict(),
                "pose_deltas": st.pose_deltas.detach(),
                "opt": st.opt.state_dict(),
                "cam_opt": st.cam_opt.state_dict(),
                "step": st.step}
        if st.occ_grid is not None:
            full["occ_grid"] = st.occ_grid
        return full

    @torch.no_grad()
    def restore_snapshot(self, path: str) -> None:
        """Mid-run resume from a ``trainstate*.pt`` that
        :meth:`save_snapshot` wrote: every model tensor (the proposal grids
        too), the occupancy grid, the pose deltas, both Adam states and the
        step, loaded in
        place, so the optimizers keep their parameter tensors. A
        ``snapshot*.pt`` (what evaluation loads) holds no Adam state: the
        optimizers are then left as they are. The
        trainer's generator is not saved (the JAX stage does not save its
        key either): a resumed run draws other rays than an unbroken one.
        Goes beyond the reference, whose snapshots serve post-hoc
        evaluation only (SURVEY.md §5.4)."""
        # loaded to the host: Adam keeps its step counts on the host and
        # moves the moments to each parameter's device itself
        blob = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(blob["model"])
        self.state.pose_deltas.copy_(blob["pose_deltas"])
        if "occ_grid" in blob:
            self.state.occ_grid.copy_(blob["occ_grid"])
        if "opt" in blob:
            self.state.opt.load_state_dict(blob["opt"])
            self.state.cam_opt.load_state_dict(blob["cam_opt"])
        self.state.step = int(blob["step"])
        self.step_count = self.state.step

    def save_snapshot(self, dir_prediction: str) -> None:
        """``snapshots/trainstate<step>.pt`` (the full resumable state),
        ``snapshots/snapshot<step>.pt`` (model tensors, pose deltas, step
        and any occupancy grid: what evaluation loads), ``dataset.npz``
        (the keyframe buffer's intrinsics, c2w and active count) and
        ``matrices/matrices_origin2frame_training.json`` (the optimized
        keyframe poses)."""
        snap_dir = os.path.join(dir_prediction, "snapshots")
        os.makedirs(snap_dir, exist_ok=True)
        full = self._train_state()
        torch.save(full, os.path.join(
            snap_dir, f"trainstate{self.step_count:06d}.pt"))
        torch.save({k: full[k] for k in ("model", "pose_deltas", "step",
                                         "occ_grid") if k in full},
                   os.path.join(snap_dir, f"snapshot{self.step_count:06d}.pt"))
        # training-set dump (reference dataset.pt, nerfstudio_utils.py:230-241)
        np.savez_compressed(
            os.path.join(dir_prediction, "dataset.npz"),
            intrinsics=self.buffer.intrinsics.cpu().numpy(),
            c2w=self.buffer.c2w.cpu().numpy(),
            num_active=int(self.buffer.num_active),
        )
        mats = self.trainer.optimized_c2w(self.state, self.buffer)[
            :self.num_inserted].cpu().numpy()
        os.makedirs(os.path.join(dir_prediction, "matrices"), exist_ok=True)
        with open(os.path.join(dir_prediction, "matrices",
                               "matrices_origin2frame_training.json"),
                  "w") as f:
            json.dump({str(i): m.tolist() for i, m in enumerate(mats)}, f)
