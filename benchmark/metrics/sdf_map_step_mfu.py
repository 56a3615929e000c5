"""sdf_map_step_mfu: the SDF mapping step's share of the card's peak: the
sum over precisions of the step's operations (``yardstick/sdf_flops.py``,
from the configuration's shapes) over that precision's published peak,
over the untraced step time of the same run."""

from benchmark.yardstick import peaks, sdf_flops


def read(record):
    if record.get("kind") != "map" or "step_s" not in record \
            or not hasattr(record.get("model"), "upsample_rounds") \
            or not record["trace"].device:
        return None
    ops = sdf_flops.map_step(record["model"], record["rays_per_batch"])
    least = sum(v / peaks.PEAK_FLOP_PER_S[k] for k, v in ops.items())
    return 100.0 * least / record["step_s"]
