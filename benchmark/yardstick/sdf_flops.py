"""Floating-point operations of one train step of Neuralangelo's SDF
mapper, by precision, from the configuration's shapes alone (never read
from the program).

Counted as ``yardstick/flops.py`` counts them (``mlp``, ``interp``):

- the up-sampling's SDF evaluations, without gradient: the float32 SDF MLP
  and the interpolation at the stratified samples and the new samples of
  every round but the last (64 + 3 x 16 = 112 points a ray);
- the final samples and their four taps (128 x 5 = 640 points a ray):
  forward (interpolation, float32 SDF MLP), then the backward: twice the
  SDF MLP (input and weight gradients) and twice the interpolation (table
  gradient, and the position gradient the pose correction needs);
- the bf16 colour MLP at the final samples (128 a ray), forward and
  backward (three times).

The resampling, sorts, compositing, losses and AdamW are elementwise or
logarithmic and not counted, so the share of the peak this gives is a
lower bound of the work done.
"""

from __future__ import annotations

from typing import Dict

from benchmark.yardstick.flops import interp, mlp


def map_step(mc, rays: int) -> Dict[str, float]:
    """{"bfloat16": ..., "float32": ...} operations of one step of the
    mapper ``mc`` (``reference.sdf_mapper.SDFMapperConfig``) at ``rays``
    rays."""
    from benchmark.reference.sdf_mapper import TAPS, _mlp_dims

    dims = _mlp_dims(mc)
    sdf, col = mlp(dims["sdf_mlp"]), mlp(dims["color_mlp"])
    fi = interp(mc.num_grid_levels, mc.grid_features_per_level)
    final = mc.num_samples + mc.upsample_rounds * mc.num_importance
    upsample = rays * (mc.num_samples
                       + (mc.upsample_rounds - 1) * mc.num_importance)
    points = rays * final * (1 + len(TAPS))
    return {"bfloat16": 3 * rays * final * col,
            "float32": upsample * (sdf + fi) + 3 * points * (sdf + fi)}
