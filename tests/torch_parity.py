"""Helpers shared by the port's mapping parity tests: the random draws of
one JAX mapping train step, reproduced from its key exactly as the JAX
package splits it, so that the port's ``train_step(..., draws)`` sees the
same pixels and stratification uniforms (and, on an occupancy refresh step,
the same slab jitter)."""

import jax
import numpy as np
import torch


def render_uniforms(k_render, n_rays, num_proposal_samples, num_nerf_samples):
    """The uniforms of one training render (``NerfactoModel.render``): the
    key splits into one per stage; the bins draw [R, S0+1]
    (``rendering.uniform_bins``), each PDF resampling [R, n+1]
    (``rendering.sample_pdf``)."""
    counts = list(num_proposal_samples) + [num_nerf_samples]
    keys = jax.random.split(k_render, len(num_proposal_samples) + 1)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (n_rays, n + 1))))
            for k, n in zip(keys, counts)]


def pixel_picks(key, n_active, height, width, n_rays):
    """The frame / row / column picks of
    ``keyframe_buffer.sample_pixel_batch(key)``."""
    k1, k2, k3 = jax.random.split(key, 3)

    def pick(k, hi):
        return torch.tensor(np.asarray(
            jax.random.randint(k, (n_rays,), 0, hi)).astype(np.int64))

    return {"frame": pick(k1, max(n_active, 1)), "py": pick(k2, height),
            "px": pick(k3, width)}


def step_draws(key, n_active, height, width, n_rays, num_proposal_samples,
               num_nerf_samples):
    """The draws of ``MappingTrainer._loss_fn(key)``: the key splits into
    (sample, render); the sample key into frame / row / column picks
    (``keyframe_buffer.sample_pixel_batch``)."""
    k_sample, k_render = jax.random.split(key)
    return dict(pixel_picks(k_sample, n_active, height, width, n_rays),
                uniforms=render_uniforms(k_render, n_rays,
                                         num_proposal_samples,
                                         num_nerf_samples))


def occupancy_render_uniforms(k_render, n_rays, num_proposal_samples,
                              num_occ_bins, num_nerf_samples):
    """The uniforms of one training render with ``sampler="occupancy"``:
    the key still splits into one per proposal stage plus one; the coarse
    bins draw [R, M+1] from the first, the PDF resampling [R, n+1] from
    the last."""
    keys = jax.random.split(k_render, len(num_proposal_samples) + 1)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (n_rays, n + 1))))
            for k, n in ((keys[0], num_occ_bins),
                         (keys[-1], num_nerf_samples))]


def occupancy_step_draws(key, n_active, height, width, n_rays,
                         num_proposal_samples, num_occ_bins,
                         num_nerf_samples, slab):
    """:func:`step_draws` of an occupancy-sampler step, plus the slab
    jitter of its refresh (``fold_in(key, 1)``, [slab, 3])."""
    d = step_draws(key, n_active, height, width, n_rays, (), 0)
    d["uniforms"] = occupancy_render_uniforms(
        jax.random.split(key)[1], n_rays, num_proposal_samples,
        num_occ_bins, num_nerf_samples)
    d["occ_jitter"] = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 1), (slab, 3))))
    return d


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
