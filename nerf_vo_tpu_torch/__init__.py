"""nerf_vo_tpu_torch — the PyTorch + CUDA port of ``nerf_vo_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and nothing of
JAX or of ``nerf_vo_tpu``. The module layout mirrors the JAX package so that
each module has an obvious counterpart:

core         SE3/SO3 Lie algebra, cameras, coordinate conventions
data         dataset loaders (Replica, 7-Scenes, ScanNet, TUM-RGBD, ETH3D)
ops          patch correlation and the hash grid's table gather / scatter
             (plain versions + hand-written CUDA kernels), bundle
             adjustment, rendering, losses, SH encoding
models       DPVO networks, Omnidata DPT, nerfacto fields and model
tracking     DPVO-style patch-graph visual odometry
enhancement  dense depth/normal priors + sparse-depth alignment
mapping      keyframe buffer + the NeRF mapping trainer
runtime      the pipeline (serial or with a frame-prefetch thread), its
             stages and their artifacts, per-stage telemetry, live viewer
evaluation   renders at GT poses, TSDF fusion, meshes, trajectory / 2D / 3D
             metrics, LPIPS
parallel     process groups, device meshes, a launcher; data-parallel and
             table-sharded mapping steps, data-parallel render chunks
utils        float-precision policy
run          the CLI: ``python -m nerf_vo_tpu_torch.run --config <name>``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
