"""Multi-device paths of the port: process groups and meshes (``dist``),
the data-parallel and table-sharded mapping steps and the data-parallel
render chunk (``sharding``).

Counterpart of ``nerf_vo_tpu/parallel/``. One process drives one rank: the
JAX package's ``shard_map`` over a device mesh becomes SPMD over
``torch.distributed`` process groups, one per mesh axis, with explicit
collectives where JAX's ``psum`` / ``all_to_all`` stood.
"""
